"""Run one of the repository's training scripts on the port, unchanged.

    python -m mxnet_tpu_torch.launch [--cpu] [--seed N] SCRIPT [ARGS...]

e.g. ``python -m mxnet_tpu_torch.launch examples/train_mnist.py
--synthetic 1 --network lenet``. The scripts ``import mxnet_tpu as mx``;
the launcher binds ``mxnet_tpu_torch`` (and each of its submodules) under
that name in ``sys.modules`` first, so the script runs on the port and the
JAX package is never imported.

- Without ``--cpu`` the default context stays ``gpu(0)``, and a machine
  without a card raises where the script first needs it. ``--cpu`` makes
  ``cpu()`` the default context of the script's thread: its arrays and
  iterators follow the default context, and ``examples/common/fit.py``
  trains on ``cpu()`` when no card is visible.
- ``--seed N`` seeds numpy's global generator, from which the scripts draw
  their synthetic data and shuffles.

After the script returns, the launcher prints one JSON line on standard
output: ``{"launch": {"launches": {kernel: count}, "fit_batches": n,
"score_batches": n, "train_window_k": k, "dispatch_depth": d, "jax":
false}}`` — each hand-written kernel's launches (the CPU path launches
none), the training steps, the validation batches, the steps per training
window and the windows in flight that ``fit`` last used
(``MXNET_TRAIN_WINDOW``, ``MXNET_DISPATCH_DEPTH``; 0 where no ``fit``
ran), and whether anything imported ``jax``.
"""

from __future__ import annotations

import json
import runpy
import sys


def _bind_port():
    import mxnet_tpu_torch

    for name, module in list(sys.modules.items()):
        if name == "mxnet_tpu_torch" or name.startswith("mxnet_tpu_torch."):
            sys.modules["mxnet_tpu" + name[len("mxnet_tpu_torch"):]] = module
    return mxnet_tpu_torch


def _counts(mx):
    tm = mx.telemetry
    kernels = tm.snapshot().get("kernel", {})
    return {
        "launches": {name: int(v["launches"]) for name, v in kernels.items()
                     if isinstance(v, dict) and "launches" in v},
        "fit_batches": tm.counter("fit.batches").value,
        "score_batches": tm.histogram("score.dispatch").count,
        "train_window_k": tm.gauge("fit.train_window_k").value,
        "dispatch_depth": tm.gauge("fit.dispatch_depth").value,
        "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    }


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    cpu, seed = False, None
    while args and args[0].startswith("--"):
        opt = args.pop(0)
        if opt == "--cpu":
            cpu = True
        elif opt == "--seed" and args:
            seed = int(args.pop(0))
        else:
            raise SystemExit(f"launch: unknown option {opt!r}; usage: python "
                             "-m mxnet_tpu_torch.launch [--cpu] [--seed N] "
                             "SCRIPT [ARGS...]")
    if not args:
        raise SystemExit("launch: no script given")
    mx = _bind_port()
    mx.telemetry.reset()
    if cpu:
        mx.context.Context._default_ctx.value = mx.cpu()
    if seed is not None:
        import numpy as np

        np.random.seed(seed)
    argv, sys.argv = sys.argv, args
    try:
        runpy.run_path(args[0], run_name="__main__")
    finally:
        sys.argv = argv
    print(json.dumps({"launch": _counts(mx)}), flush=True)


if __name__ == "__main__":
    main()
