"""Device ops: the grid kernels, window functions, instant functions
and segment reductions."""
