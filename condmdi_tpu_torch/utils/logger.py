"""Key-value training logger.

Counterpart of condmdi_tpu/utils/logger.py, a pure-Python module copied here
so that the port imports nothing of the JAX package: configure(dir,
format_strs), logkv / logkv_mean / dumpkvs / log, the output formats stdout |
log | json | csv | tensorboard (optional) | wandb (optional), and the
`profile`/`profile_kv` wall-time scopes. `log.txt` and `progress.csv` come
out as the JAX package writes them: the csv's columns are the sorted keys in
the order they first appear, and a new key rewrites the header and pads the
rows before it.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError

    def close(self):
        pass


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "at")
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

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "at")

    def writekvs(self, kvs):
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    def __init__(self, filename):
        self.filename = filename
        self.file = open(filename, "a+t")
        self.keys = []

    def writekvs(self, kvs):
        extra_keys = list(kvs.keys() - self.keys)
        extra_keys.sort()
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.truncate()
            self.file.write(",".join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line.rstrip("\n") + "," * len(extra_keys) + "\n")
        self.file.write(",".join(str(kvs.get(k, "")) for k in self.keys) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    def __init__(self, log_dir):
        from tensorboardX import SummaryWriter  # optional

        self.writer = SummaryWriter(log_dir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), step)
        self.step = step + 1

    def close(self):
        self.writer.close()


class WandbOutputFormat(KVWriter):
    def __init__(self):
        import wandb  # optional

        self.wandb = wandb

    def writekvs(self, kvs):
        self.wandb.log(kvs)


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(os.path.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        try:
            return TensorBoardOutputFormat(os.path.join(ev_dir, "tb"))
        except Exception:
            return HumanOutputFormat(sys.stdout)
    if fmt == "wandb":
        try:
            return WandbOutputFormat()
        except Exception:
            return HumanOutputFormat(sys.stdout)
    raise ValueError(f"Unknown format: {fmt}")


class Logger:
    CURRENT: Optional["Logger"] = None
    DEFAULT: Optional["Logger"] = None

    def __init__(self, dir, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        if self.level == DISABLED:
            return {}
        out = dict(self.name2val)
        for fmt in self.output_formats:
            if isinstance(fmt, KVWriter):
                fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def configure(dir: Optional[str] = None, format_strs=None, log_suffix=""):
    if dir is None:
        import tempfile

        dir = os.environ.get("CONDMDI_LOGDIR") or os.path.join(
            tempfile.gettempdir(),
            "condmdi-" + datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S"),
        )
    if format_strs is None:
        format_strs = os.environ.get("CONDMDI_LOG_FORMAT", "stdout,log,csv").split(",")
    format_strs = [f for f in format_strs if f]
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    return Logger.CURRENT


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure(format_strs=["stdout"])
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, **kwargs):
    get_current().log(*args, **kwargs)


def get_dir():
    return get_current().dir


# ---- wall-time profiling scopes ------------------------------------------- #
@contextmanager
def profile_kv(scopename):
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart


def profile(n):
    def decorator_with_name(func):
        @functools.wraps(func)
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return func_wrapper

    return decorator_with_name
