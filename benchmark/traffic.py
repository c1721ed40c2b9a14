"""The traffic generator: one reader for every mix file in ``traffic/``.

A mix is a JSON file of parameters.  Its ``kind`` names the module
``kinds/<kind>.py`` that makes the cell's population and runs one window of
it (``setup``, ``window``, ``check``); its ``warmup_windows``,
``trace_windows`` and ``sync_windows`` say how many windows the harness
runs before the measured window and under the profiler and the sync
counter in a traced run; the rest are the kind's own parameters (its
``PARAMS``).  A new mix of a kind is a data file; a new kind is a new
module beside the others, with no edit here.
"""
from __future__ import annotations

import dataclasses

COMMON = ("kind", "warmup_windows", "trace_windows", "sync_windows")


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    kind: str
    warmup_windows: int  # windows run before the measured window
    trace_windows: int  # windows under the profiler in a traced run
    sync_windows: int  # windows under the sync counter in a traced run
    params: dict  # the kind's own parameters


def mix(name: str, params: dict, kind_params: tuple = ()) -> Mix:
    """The mix ``name`` from its file's ``params``; ``kind_params`` are the
    keys its kind needs."""
    missing = [k for k in COMMON + tuple(kind_params) if k not in params]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    return Mix(name=name, **{k: params[k] for k in COMMON},
               params={k: v for k, v in params.items() if k not in COMMON})


def host_seed(seed: int) -> int:
    """A run's seed as a non-negative numpy seed (any whole number maps)."""
    return int(seed) % (1 << 64)
