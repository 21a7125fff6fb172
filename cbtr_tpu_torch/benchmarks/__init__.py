"""Microbenchmarks of the card: the measured FP32 FMA peak (`fma_peak`, run
as a module), the roofline of the bench's sweep rows."""
