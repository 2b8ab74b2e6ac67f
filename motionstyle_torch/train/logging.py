"""OpenAI-baselines-style KV logger: logkv / logkv_mean / dumpkvs with
stdout-table, CSV and JSON sinks. The port's own copy of
motionstyle/train/logging.py, which it may not import.

Parity: diffusion/logger.py (Logger singleton :361+, HumanOutputFormat :36,
JSONOutputFormat :98, CSVOutputFormat). Consumed by the training loop for the
per-step loss table and the quartile-bucketed per-timestep losses
(training_loop.py:385-397).
"""
from __future__ import annotations

import datetime
import json
import os
import os.path as osp
import sys
import tempfile
from collections import defaultdict


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError


class HumanOutputFormat(KVWriter):
    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | {val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "w+t")
        self.keys = []

    def writekvs(self, kvs):
        extra_keys = list(kvs.keys() - self.keys)
        extra_keys.sort()
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.write(",".join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line[:-1] + "," * len(extra_keys) + "\n")
        self.file.write(",".join("" if kvs.get(k) is None else str(kvs.get(k)) for k in self.keys) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


def make_output_format(fmt, ev_dir, log_suffix=""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    CURRENT = None

    def __init__(self, dir, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        d = dict(self.name2val)
        for fmt in self.output_formats:
            fmt.writekvs(d)
        self.name2val.clear()
        self.name2cnt.clear()
        return d

    def log(self, *args):
        print(*args)

    def close(self):
        for fmt in self.output_formats:
            if hasattr(fmt, "close"):
                fmt.close()


def configure(dir=None, format_strs=("stdout", "log", "csv"), log_suffix=""):
    if dir is None:
        dir = osp.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("motionstyle-torch-%Y-%m-%d-%H-%M-%S-%f"),
        )
    os.makedirs(dir, exist_ok=True)
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    return Logger.CURRENT


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure(format_strs=("stdout",))
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args):
    get_current().log(*args)


def log_loss_dict(num_timesteps, ts, losses):
    """Per-term mean plus quartile-bucketed per-timestep means
    ({key}_q{0..3} by 4*t/T); parity: training_loop.py:385-390 (the generic
    prior-training logger; the style finetune path logs plain means, :392)."""
    import numpy as np

    ts = np.asarray(ts)
    for key, values in losses.items():
        values = np.asarray(values)
        logkv_mean(key, float(values.mean()))
        for sub_t, sub_loss in zip(ts.reshape(-1), values.reshape(-1)):
            quartile = int(4 * sub_t / num_timesteps)
            logkv_mean(f"{key}_q{quartile}", float(sub_loss))


def print_current_loss(start_time, niter_state, losses, epoch=None,
                       sub_epoch=None, inner_iter=None, tf_ratio=None,
                       sl_steps=None):
    """Console progress line for the vendored eval trainers; parity:
    data_loaders/humanml/utils/utils.py:36-62 (elapsed minutes + one
    '%s: %.4f' pair per loss term, optional epoch/teacher-forcing tail)."""
    import time as _time

    def as_minutes(s):
        m = int(s // 60)
        return "%dm %ds" % (m, int(s - m * 60))

    if epoch is not None:
        print("epoch: %3d niter: %6d sub_epoch: %2d inner_iter: %4d"
              % (epoch, niter_state, sub_epoch or 0, inner_iter or 0),
              end=" ")
    message = as_minutes(_time.time() - start_time)
    for k, v in losses.items():
        message += " %s: %.4f " % (k, float(v))
    if sl_steps is not None or tf_ratio is not None:
        message += " sl_length:%2d tf_ratio:%.2f" % (sl_steps or 0,
                                                     tf_ratio or 0.0)
    print(message)
