"""Device ms of a train step's backward: busy time less the kernels under ``train/forward`` and
``train/optimizer``. Autograd runs the backward (the chunks' recompute, the hash tables' gradient
scatter, K1's and K2's backward) on its own thread, outside the step's labelled ranges."""


def read(view):
    fwd = view.label_ms_per_unit("train/forward")
    if fwd is None or view.units == 0:
        return None
    opt = view.label_ms_per_unit("train/optimizer") or 0.0
    return view.busy_us / 1e3 / view.units - fwd - opt
