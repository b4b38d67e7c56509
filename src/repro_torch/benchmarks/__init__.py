"""The port's benchmark runner (``run``) and its suites: the HALO analytic
model's paper figures (``paper_figs``) and the kernel micro-benchmarks
(``kernel_micro``)."""
