"""Driver kinds, one module each, named by a traffic mix's `driver` key.

A driver module has `setup(cell, seed, device)`, which builds the program's
objects from the cell's configuration and mix, warms up every shape the cell
uses and returns a state with:

* `unit()` -> (work, ok): one unit of work, returned once it has completed;
* `end_to_end(window)` -> {metric: value} for the cell's end-to-end metrics;
* `check()` -> {number: value}: the numbers `correct` is decided on, worked
  out after the window (it may free the program's state);
* `SPANS`: the (label, module, attribute) spans of a traced unit.
"""
