"""Device ms a train step spends in kernels launched under the port's ``hash_encode`` range
(field_components/encodings.py): the grids' forward gathers, and their recompute in the backward
pass."""


def read(view):
    return view.label_ms_per_unit("hash_encode")
