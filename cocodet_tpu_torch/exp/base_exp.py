"""Experiment configs (cocodet_tpu/exp/base_exp.py): ``BaseExp`` and its
CLI ``merge``, and ``get_exp`` by file or by registry name.

An experiment is a Python class whose attributes the CLI may override
(``merge``: literal-eval with a string fallback, existing attributes only)
and whose factories build the model, loader, optimizer, schedule and
evaluator; it holds no training state.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import sys
from typing import Any, Dict, Optional, Sequence, Tuple


class BaseExp:
    """Abstract experiment. Subclasses define the factories below."""

    seed: Optional[int] = None
    output_dir: str = "./outputs"
    print_interval: int = 100
    eval_interval: int = 10
    exp_name: str = "base"

    def get_model(self, *args, **kwargs):
        raise NotImplementedError

    def get_data_loader(self, batch_size: int, is_distributed: bool, no_aug: bool = False,
                        cache_img: bool = False):
        raise NotImplementedError

    def get_optimizer(self, batch_size: int, model):
        raise NotImplementedError

    def get_lr_scheduler(self, lr: float, iters_per_epoch: int):
        raise NotImplementedError

    def get_evaluator(self, batch_size: int, is_distributed: bool, testdev: bool = False):
        raise NotImplementedError

    def merge(self, opts: Optional[Sequence[str]]):
        """Apply trailing CLI ``key value`` pairs (base_exp.py:54-72)."""
        if not opts:
            return self
        assert len(opts) % 2 == 0, "override opts must be key/value pairs"
        for k, v in zip(opts[0::2], opts[1::2]):
            k = k.lstrip("-")
            if not hasattr(self, k):
                raise AttributeError(f"experiment has no attribute {k!r}")
            src = getattr(self, k)
            try:
                val = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                val = v
            if src is not None and val is not None:
                val = type(src)(val) if not isinstance(val, type(src)) else val
            setattr(self, k, val)
        return self

    def __repr__(self):
        rows = [f"  {k:25s} = {getattr(self, k)!r}" for k in sorted(dir(self))
                if not k.startswith("_") and not callable(getattr(self, k))]
        return "Exp(\n" + "\n".join(rows) + "\n)"


def get_exp_by_file(exp_file: str) -> BaseExp:
    """Import an experiment file and instantiate its ``Exp`` class."""
    path = os.path.abspath(exp_file)
    name = os.path.basename(path).split(".")[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod.Exp()


_NAME_REGISTRY: Dict[str, Tuple[str, Dict[str, Any]]] = {}


def register_exp(name: str, cls_path: str, **overrides):
    _NAME_REGISTRY[name] = (cls_path, overrides)


def get_exp_by_name(exp_name: str) -> BaseExp:
    """The built-in registry (yolox-s/m/l/x/tiny/nano, yolox-m-p6, ...)."""
    key = exp_name.replace("_", "-")
    if key not in _NAME_REGISTRY:
        raise KeyError(f"unknown exp name {exp_name!r}; known: {sorted(_NAME_REGISTRY)}")
    cls_path, overrides = _NAME_REGISTRY[key]
    module_name, cls_name = cls_path.rsplit(".", 1)
    exp = getattr(importlib.import_module(module_name), cls_name)()
    for k, v in overrides.items():
        setattr(exp, k, v)
    exp.exp_name = key
    return exp


def get_exp(exp_file: Optional[str] = None, exp_name: Optional[str] = None) -> BaseExp:
    """By file if given, else by registry name."""
    assert exp_file is not None or exp_name is not None
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    return get_exp_by_name(exp_name)
