"""``paper_encode_kernel``'s share of its roofline in a train step: its bound
(its bytes over 3.35 TB/s, as the kind's ``work`` counts them under
``kernels``) over the device time of the kernels of that name in the step,
in %."""

from benchmark import kernel_roofline


def read(run):
    return kernel_roofline.share(run, "paper_encode_kernel")
