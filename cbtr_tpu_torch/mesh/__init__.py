"""Host-side triangle-mesh layer (NumPy): STL I/O, welding, topology."""
