"""Metric-reporting platforms for the trainers (parity:
train/train_platforms.py; counterpart of motionstyle/train/platforms.py).

TensorboardPlatform writes TensorBoard event files through tensorboardX,
imported when the platform is built, as the JAX class does: where
tensorboardX is missing, building it raises ImportError. The H100 machine
the port is measured on has no tensorboardX (chip_smoke.py's item12 phase
probes it): there the finetune's default --train_platform_type raises, and
runs pass --train_platform_type NoPlatform. ClearmlPlatform
reports to ClearML where clearml imports and a task starts; otherwise it
warns once and does nothing, as the JAX class does, so it needs no package.
"""
from __future__ import annotations

import os


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


class TensorboardPlatform(TrainPlatform):
    def __init__(self, save_dir):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(log_dir=save_dir)

    def report_scalar(self, name, value, iteration, group_name=None):
        self.writer.add_scalar(f"{group_name}/{name}", value, iteration)

    def close(self):
        self.writer.close()


class ClearmlPlatform(TrainPlatform):
    def __init__(self, save_dir):
        try:
            from clearml import Task

            name = os.path.basename(os.path.normpath(save_dir)) or save_dir
            self.task = Task.init(project_name="motionstyle", task_name=name)
            self.logger = self.task.get_logger()
        except Exception as ex:  # no clearml or no server: report nothing
            print(f"clearml unavailable ({type(ex).__name__}: {ex}); "
                  "falling back to NoPlatform behavior")
            self.task = None
            self.logger = None

    def report_scalar(self, name, value, iteration, group_name=None):
        if self.logger is not None:
            self.logger.report_scalar(title=group_name, series=name, iteration=iteration,
                                      value=value)

    def report_args(self, args, name):
        if self.task is not None:
            self.task.connect(args, name=name)

    def close(self):
        if self.task is not None:
            self.task.close()


PLATFORMS = {cls.__name__: cls for cls in
             (TrainPlatform, NoPlatform, TensorboardPlatform, ClearmlPlatform)}


def get_platform(name: str, save_dir: str) -> TrainPlatform:
    """The platform class `name` (--train_platform_type) built on save_dir,
    as the JAX CLI builds it (getattr(platforms, name)(save_dir))."""
    if name not in PLATFORMS:
        raise ValueError(f"unknown train platform {name!r}; one of {sorted(PLATFORMS)}")
    return PLATFORMS[name](save_dir)
