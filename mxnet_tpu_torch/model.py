"""Checkpoint files and the training-loop helpers of the legacy model API.

Counterpart of ``mxnet_tpu/model.py`` (reference ``python/mxnet/model.py``)
for ``BatchEndParam``, ``save_checkpoint``/``load_checkpoint`` (the
``<prefix>-symbol.json`` and ``<prefix>-<epoch>.params`` pair, readable by
either package), ``_create_kvstore`` and ``_update_params``. Both files are
written to a temporary name, flushed to disk and renamed, so a crash never
leaves a torn file. The kvstore and the ``FeedForward`` API are not yet
ported: one device needs no store, and asking for one on several devices
raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
from collections import namedtuple

from . import symbol as sym_mod
from .base import MXNetError
from .ndarray import load as nd_load, save as nd_save

BatchEndParam = namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"]
)


@contextlib.contextmanager
def atomic_path(path):
    """Yield a temporary path beside ``path``; on success fsync it and
    rename it over ``path``, on failure remove it."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(path))
    os.close(fd)
    try:
        yield tmp
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` (reference model.py:40-66). One
    device needs no reduction store; stores themselves are not yet ported."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return (None, False)
    raise MXNetError(
        f"kvstore {kvstore!r} over {num_device} device(s) is not yet ported "
        "to mxnet_tpu_torch (ROADMAP.md queue 1 items 4 and 7)")


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save symbol JSON + params (reference model.py save_checkpoint)."""
    if symbol is not None:
        with atomic_path(f"{prefix}-symbol.json") as tmp:
            symbol.save(tmp)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    with atomic_path(param_name) as tmp:
        nd_save(tmp, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def _split_param_dict(save_dict, source):
    """Split a loaded ``{prefix:name -> NDArray}`` dict into (arg, aux); a
    key that is neither ``arg:`` nor ``aux:`` raises."""
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if not _ or tp not in ("arg", "aux"):
            raise ValueError(
                f"{source}: invalid parameter key {k!r} — expected an "
                "'arg:<name>' or 'aux:<name>' prefix.")
        (arg_params if tp == "arg" else aux_params)[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params); the arrays land on the CPU."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    param_name = f"{prefix}-{epoch:04d}.params"
    arg_params, aux_params = _split_param_dict(nd_load(param_name),
                                               param_name)
    return (symbol, arg_params, aux_params)
