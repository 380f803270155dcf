"""Versioned env construction from per-task variant files.

Counterpart of ``unidom_tpu/config.py``: a task file holds ``defaults`` and
a ``variants`` list, and ``make("shape_rope-v3")`` builds the task's env with
variant 3 applied on top of the defaults (v1 = the first variant). The
variant files are JSON copies of ``unidom_tpu/configs/*.yml`` in
``unidom_torch/configs/``, so that nothing here needs a YAML parser.
Overrides are env-constructor keyword arguments; physical parameters that
live in the state (stiffness, E, nu, yield_stress, friction) are the
state's, so sweeping them builds nothing anew.
"""

import json
import os
import re

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def load_task_config(task: str):
    """The task's variant file as a dict (empty when it has none)."""
    path = os.path.join(CONFIG_DIR, f"{task}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f) or {}


def resolve_variant(task: str, version: int):
    """The task's defaults merged with variants[version - 1]."""
    spec = load_task_config(task)
    base = dict(spec.get("defaults", {}))
    variants = spec.get("variants", [])
    if version >= 1 and version - 1 < len(variants):
        base.update(variants[version - 1] or {})
    return base


_SPEC_RE = re.compile(r"^(?P<task>[a-z0-9_]+?)(?:-v(?P<version>\d+))?$")


def parse_env_spec(spec: str):
    """``"task-vN"`` -> (task, N); no version is v1."""
    m = _SPEC_RE.match(spec.lower())
    if not m:
        raise ValueError(f"bad env spec {spec!r}")
    return m.group("task"), int(m.group("version") or 1)


def make(spec: str, batch_size: int = 1, **kwargs):
    """Versioned env factory: ``make("shape_rope-v2", batch_size=4)``; the
    keyword arguments (``device`` among them) go to the constructor after
    the variant's."""
    from unidom_torch.envs.registration import env_functions

    task, version = parse_env_spec(spec)
    if task not in env_functions:
        raise KeyError(f"unknown task {task!r}")
    overrides = resolve_variant(task, version)
    overrides.update(kwargs)
    return env_functions[task](batch_size=batch_size, **overrides)

