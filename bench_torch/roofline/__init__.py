"""The operations and bytes of the port's kernels, from their shapes."""
