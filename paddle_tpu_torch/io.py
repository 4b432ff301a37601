"""Checkpoint save/load: the port of the JAX package's ``io.py`` (the
reference's fluid save_op / load_op and ``fluid.io.save_params`` /
``save_inference_model``, with the Go pserver's checkpoint integrity
meta and atomic rename, go/pserver/service.go:120,346).

The same on-disk format as the JAX package, so a checkpoint written by
either loads into the other: each variable one ``.npy`` file, a
``MANIFEST.json`` with ``format_version`` 1, a timestamp and the sha256
of each file; a save writes a temporary directory beside the target and
renames it into place. Values are saved from the scope as host numpy
(read back from the device) and loaded into the scope as CPU tensors;
the Executor moves them to its device on the next run.
``save_inference_model`` prunes a test clone of the program to the
targets and pickles it beside the parameters.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.framework.program import (Parameter, Program,
                                                default_main_program)

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model", "CheckpointError",
]

_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    pass


def _var_filename(name: str) -> str:
    return name.replace("/", "%2F") + ".npy"


def save_vars(executor, dirname: str, var_names: List[str],
              scope=None) -> str:
    scope = scope or global_scope()
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(dirname)) or ".",
                           prefix=".ckpt_tmp_")
    manifest = {"format_version": _FORMAT_VERSION, "timestamp": time.time(),
                "vars": {}}
    try:
        for name in var_names:
            arr = scope.get_tensor(name).array.detach().cpu().numpy()
            fname = _var_filename(name)
            path = os.path.join(tmp, fname)
            np.save(path, arr, allow_pickle=False)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["vars"][name] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha256": digest,
            }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(dirname):
            shutil.rmtree(dirname)
        os.replace(tmp, dirname)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dirname


def load_vars(executor, dirname: str, var_names: Optional[List[str]] = None,
              scope=None, verify_integrity: bool = True):
    scope = scope or global_scope()
    mpath = os.path.join(dirname, "MANIFEST.json")
    if not os.path.exists(mpath):
        raise CheckpointError(f"no MANIFEST.json in {dirname}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format_version", 0) > _FORMAT_VERSION:
        raise CheckpointError("checkpoint written by a newer format version")
    names = var_names or list(manifest["vars"].keys())
    for name in names:
        meta = manifest["vars"].get(name)
        if meta is None:
            raise CheckpointError(f"variable {name!r} not in checkpoint")
        path = os.path.join(dirname, meta["file"])
        if verify_integrity:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != meta["sha256"]:
                raise CheckpointError(f"integrity check failed for {name!r}")
        scope.set_tensor(name, torch.from_numpy(np.load(path,
                                                        allow_pickle=False)))
    return names


def _param_names(program: Optional[Program], predicate) -> List[str]:
    program = program or default_main_program()
    return [v.name for v in program.global_block().vars.values() if predicate(v)]


def save_params(executor, dirname: str, main_program=None, scope=None):
    names = _param_names(main_program, lambda v: isinstance(v, Parameter))
    return save_vars(executor, dirname, names, scope)


def save_persistables(executor, dirname: str, main_program=None, scope=None):
    scope = scope or global_scope()
    names = [n for n in _param_names(main_program, lambda v: v.persistable)
             if scope.has_var(n) and scope.find_var(n) is not None]
    return save_vars(executor, dirname, names, scope)


def load_params(executor, dirname: str, main_program=None, scope=None):
    names = _param_names(main_program, lambda v: isinstance(v, Parameter))
    return load_vars(executor, dirname, names, scope)


def load_persistables(executor, dirname: str, main_program=None, scope=None):
    return load_vars(executor, dirname, None, scope)


def _prune_for_inference(program: Program, target_names: List[str]):
    """Drop ops not needed to compute ``target_names`` — training-only
    ops (loss, backward, optimizer updates) vanish from the saved model
    (ref framework/prune.cc, used by fluid save_inference_model).

    Reverse walk: an op survives iff one of its outputs is needed so
    far; its inputs then become needed. Optimizer ops are visited before
    the forward ops that read the parameters (reverse program order), so
    their writes never intersect the needed set and they are pruned."""
    block = program.global_block()
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch", "backward"):
            continue
        if any(n in needed for n in op.output_names()):
            kept.append(op)
            needed.update(op.input_names())
    block.ops = list(reversed(kept))
    program._version += 1


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars, executor, main_program=None,
                         scope=None):
    """(ref fluid/io.py save_inference_model): program topology pruned
    to the inference slice + params."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    infer_program = main_program.clone(for_test=True)
    _prune_for_inference(infer_program, [t.name for t in target_vars])
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [t.name for t in target_vars],
    }
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        pickle.dump({"program": infer_program, "meta": meta}, f)
    save_params(executor, os.path.join(dirname, "params"), main_program, scope)
    return dirname


def load_inference_model(dirname: str, executor, scope=None):
    with open(os.path.join(dirname, "__model__"), "rb") as f:
        blob = pickle.load(f)
    program = blob["program"]
    load_params(executor, os.path.join(dirname, "params"), program, scope)
    return program, blob["meta"]["feed_names"], blob["meta"]["fetch_names"]
