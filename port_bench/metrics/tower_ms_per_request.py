"""``models/conv_net.ConvTower``: device milliseconds a request spends in
cuDNN's convolution kernels, named by these words (as a trace shows them)."""

CONV_KERNEL_WORDS = ("conv", "cudnn", "fprop", "implicit")


def read(r):
    durations = [dur for name, _, dur, _ in r.trace.kernels()
                 if any(w in name.lower() for w in CONV_KERNEL_WORDS)]
    return 1e-3 * sum(durations) / r.traced if durations else None
