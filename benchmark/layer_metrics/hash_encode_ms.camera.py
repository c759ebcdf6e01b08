"""Device ms a camera request spends in kernels launched under the port's ``hash_encode`` range
(field_components/encodings.py): the hash grids' gathers of every render chunk."""


def read(view):
    return view.label_ms_per_unit("hash_encode")
