"""Device ms a radar request spends in kernels launched under the port's ``radar_decoder`` range
(models/neuradar.py): the transformer with K2 and the four heads."""


def read(view):
    return view.label_ms_per_unit("radar_decoder")
