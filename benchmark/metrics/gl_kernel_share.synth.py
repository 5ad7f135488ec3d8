"""Share of Griffin-Lim's iterations that ran on its kernels
(``griffin_lim_kernel_iters``, counted by ``ops/griffin_lim.py``) rather than
the plain loop (``griffin_lim_plain_iters``, ``dsp/torch_dsp.py``), in
percent over the process: a count, which repeats exactly while the calls'
shapes and code stay the same. None where the program counts neither."""

from benchmark.spans import counters_of_run


def read(layer):
    c = counters_of_run(layer)
    if not c:
        return None
    kernel, plain = c.get("griffin_lim_kernel_iters", 0), c.get("griffin_lim_plain_iters", 0)
    if kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
