"""KALDI_LOG / KALDI_WARN / KALDI_VLOG-style logging with a verbosity
level (the reference's base/kaldi-error conventions, used throughout
bd-nnet-train-lstm-streams.cc)."""

from __future__ import annotations

import sys
import time

_VERBOSE_LEVEL = 0


def set_verbose_level(level: int) -> None:
    global _VERBOSE_LEVEL
    _VERBOSE_LEVEL = int(level)


def get_verbose_level() -> int:
    return _VERBOSE_LEVEL


def _emit(tag: str, msg: str) -> None:
    ts = time.strftime("%H:%M:%S")
    print(f"{tag} ({ts}) {msg}", file=sys.stderr, flush=True)


def LOG(msg: str) -> None:
    _emit("LOG", msg)


def WARN(msg: str) -> None:
    _emit("WARNING", msg)


def ERROR(msg: str) -> None:
    _emit("ERROR", msg)


def VLOG(level: int, msg: str) -> None:
    if _VERBOSE_LEVEL >= level:
        _emit(f"VLOG[{level}]", msg)
