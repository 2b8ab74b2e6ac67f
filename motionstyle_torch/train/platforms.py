"""Metric-reporting platforms for the trainers (parity:
train/train_platforms.py; counterpart of motionstyle/train/platforms.py).

Only NoPlatform is ported: the TensorBoard and ClearML platforms need
packages (tensorboard / tensorboardX, clearml) that the GPU machine does not
have. Asking for them raises, naming the ROADMAP item.
"""
from __future__ import annotations


class TrainPlatform:
    def __init__(self, save_dir):
        pass

    def report_scalar(self, name, value, iteration, group_name=None):
        pass

    def report_args(self, args, name):
        pass

    def close(self):
        pass


class NoPlatform(TrainPlatform):
    pass


def get_platform(name: str, save_dir: str) -> TrainPlatform:
    if name == "NoPlatform":
        return NoPlatform(save_dir)
    raise NotImplementedError(
        f"--train_platform_type {name} is not ported to motionstyle_torch "
        "(ROADMAP §1 item 12: it needs a package the GPU machine lacks); "
        "pass --train_platform_type NoPlatform")
