"""Device-idle ms a frame inside the port's ``lomanerf.nerf.render_image``
span: ``get_rays``, the chunk loop and the concatenation, with the render
calls inside them."""

from benchmark import spans


def read(run):
    return None if run.trace is None else spans.idle_ms(run.trace, spans.RENDER_IMAGE)
