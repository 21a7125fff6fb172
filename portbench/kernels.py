"""The port's kernels by their base names (`tracing.base_name`), as the
profiler reports them."""

K1 = "sweep_select_kernel"            # csrc/sweep_select.cu, P <= 1024
K2 = "winner_kernel"                  # csrc/winner.cu, P > 1024
RECOMPUTE_KERNELS = ["recompute_forward_kernel", "recompute_backward_kernel"]
SEGMENT_SUM_KERNELS = ["tile_histogram", "tile_scatter", "segment_bounds", "scan_digits",
                       "scan_nodes", "fold_rows", "fold_values"]
