"""Device ms a train step spends in kernels launched under the port's ``train/forward`` range
(engine/trainer.py): the forward of every chunk and the losses."""


def read(view):
    return view.label_ms_per_unit("train/forward")
