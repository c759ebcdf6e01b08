"""Device ms of the splatfacto train step's optimizer: the kernels launched inside the port's
``train/optimizer`` ranges (Adam over the six parameter groups of 1,048,576 gaussians), per traced
step."""


def read(view):
    return view.label_ms_per_unit("train/optimizer")
