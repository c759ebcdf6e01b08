"""Device ms a camera request spends in the RGB decoder (model_components/cnns.py): the kernels
launched under its convolutions and batch norms (``aten::convolution``, ``aten::batch_norm``), the
only ones of a render request; the render path gives the decoder no range of its own."""


def read(view):
    parts = [view.label_ms_per_unit(label) for label in ("aten::convolution", "aten::batch_norm")]
    if parts[0] is None:
        return None
    return sum(p for p in parts if p is not None)
