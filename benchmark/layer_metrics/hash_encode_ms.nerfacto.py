"""Device ms a nerfacto train step spends in kernels launched under the port's ``hash_encode`` range
(field_components/encodings.py): K4's forward on the two proposal grids and the field's grid."""


def read(view):
    return view.label_ms_per_unit("hash_encode")
