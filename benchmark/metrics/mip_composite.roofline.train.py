"""``mip_composite_kernel``'s share of its roofline in a train step: the NeRF's
rgb head and compositing's, forward and backward, bound (its operations and
bytes as the kind's ``work`` counts them under ``kernels``) over the device
time of the kernels of that name in the step, in %."""

from benchmark import kernel_roofline


def read(run):
    return kernel_roofline.share(run, "mip_composite_kernel")
