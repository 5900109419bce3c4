"""ILS device orchestration (`ils`) and its kernels (`ils_kernels`)."""
