"""Device ops: the aligned-grid kernels and segment reductions."""
