"""Structured key-value logger with human / JSON / CSV sinks and profile
timers (port of diffpure_tpu/utils/kvlogger.py).

The OpenAI-baselines logger vendored by the reference (ref
guided_diffusion/logger.py:44-330): logkv / logkv_mean / dumpkvs with
several output formats, the profile_kv context timer and the @profile
decorator. ``TrainLoop`` logs through it. A tensor value is logged as its
float.
"""
from __future__ import annotations

import csv
import functools
import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, TextIO

import torch

DEBUG, INFO, WARN, ERROR, DISABLED = 10, 20, 30, 40, 50


class KVWriter:
    def writekvs(self, kvs: Dict) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter):
    """ref logger.py:58-106."""

    def __init__(self, file: TextIO):
        self.file = file

    def writekvs(self, kvs: Dict) -> None:
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._trunc(key)] = self._trunc(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} "
                         f"| {val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 30) -> str:
        return s[:maxlen - 3] + "..." if len(s) > maxlen else s


class JSONOutputFormat(KVWriter):
    """ref logger.py:109-120."""

    def __init__(self, file: TextIO):
        self.file = file

    def writekvs(self, kvs: Dict) -> None:
        out = {k: (float(v) if hasattr(v, "dtype") or hasattr(v, "__float__")
                   else v) for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()


class CSVOutputFormat(KVWriter):
    """ref logger.py:123-160 (rewrites header when new keys appear)."""

    def __init__(self, path: str):
        self.path = path
        self.keys: List[str] = []

    def writekvs(self, kvs: Dict) -> None:
        extra = sorted(set(kvs.keys()) - set(self.keys))
        if extra:
            self.keys += extra
            rows = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self.keys)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys)
            w.writerow({k: kvs.get(k, "") for k in self.keys})


def make_output_format(fmt: str, ev_dir: str, suffix: str = "") -> KVWriter:
    """ref logger.py:163-196."""
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(open(os.path.join(ev_dir,
                                                   f"log{suffix}.txt"), "a"))
    if fmt == "json":
        return JSONOutputFormat(open(os.path.join(
            ev_dir, f"progress{suffix}.json"), "a"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, f"progress{suffix}.csv"))
    raise ValueError(f"unknown format {fmt}")


def _value(val):
    """A one-element tensor as its Python number (JAX's sinks print a 0-d
    array as its number). Values stay tensors until ``dumpkvs``, so that
    logging a device tensor does not wait for the device."""
    return val.item() if isinstance(val, torch.Tensor) and val.numel() == 1 else val


class KVLogger:
    """ref logger.py:352-420 (Logger class)."""

    def __init__(self, dir: Optional[str] = None,
                 output_formats: Optional[List[KVWriter]] = None,
                 level: int = INFO):
        self.name2val: Dict = defaultdict(float)
        self.name2cnt: Dict = defaultdict(int)
        self.dir = dir
        self.level = level
        self.output_formats = output_formats or [HumanOutputFormat(sys.stdout)]
        self._profile_starts: Dict[str, float] = {}

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val) -> None:
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> Dict:
        out = {k: _value(v) for k, v in self.name2val.items()}
        for fmt in self.output_formats:
            fmt.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level: int = INFO) -> None:
        if self.level <= level:
            print(*args)

    # --- profiling (ref logger.py:302-330) ---------------------------------

    @contextmanager
    def profile_kv(self, scopename: str):
        key = f"wait_{scopename}"
        t0 = time.time()
        try:
            yield
        finally:
            self.name2val[key] += time.time() - t0

    def profile(self, n: str):
        def decorator(func):
            @functools.wraps(func)
            def wrapper(*args, **kwargs):
                with self.profile_kv(n):
                    return func(*args, **kwargs)
            return wrapper
        return decorator


_CURRENT: Optional[KVLogger] = None


def configure(dir: Optional[str] = None,
              format_strs: Optional[List[str]] = None) -> KVLogger:
    """ref logger.py:435-470."""
    global _CURRENT
    dir = dir or os.path.join(os.getcwd(), "logs")
    format_strs = format_strs if format_strs is not None else ["stdout", "log",
                                                               "csv"]
    formats = [make_output_format(f, dir) for f in format_strs]
    _CURRENT = KVLogger(dir=dir, output_formats=formats)
    return _CURRENT


def get_current() -> KVLogger:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = KVLogger()
    return _CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, **kwargs):
    get_current().log(*args, **kwargs)
