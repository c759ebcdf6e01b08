"""Device ms a nerfacto train step spends in kernels launched under the port's ``proposal_sampling``
range (models/nerfacto.py): the initial sampler, both proposal networks' forwards (their grids' K4
encodes and MLPs) and the two pdf samplings; the backward runs on autograd's thread, outside it."""


def read(view):
    return view.label_ms_per_unit("proposal_sampling")
