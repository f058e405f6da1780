"""The BASELINE training scripts on the PyTorch port, held against the JAX
package on the CPU.

``examples/train_mnist.py --synthetic 1`` (MLP and LeNet) and a small
``examples/train_imagenet.py --benchmark 1`` (ResNet-18 at 3x32x32, 10
classes, batch 8, 16 examples, ``--kv-store device``) run unchanged: the
port's in one subprocess through ``python -m mxnet_tpu_torch.launch
--cpu`` (the port bound as ``mxnet_tpu``, the CPU asked for explicitly),
the JAX package's in another. Both start from one checkpoint the test
writes (``--model-prefix``/``--load-epoch 0``), with numpy's global
generator seeded the same way before each script, so the synthetic data,
its shuffle and the weights agree; each trains one epoch through
``examples/common/fit.py`` (a ``kv.create`` store that owns the update,
``Module.fit`` with device prefetch on, the Speedometer, the epoch
checkpoint) and the epoch-1 checkpoints are compared: every parameter
and BatchNorm statistic within rtol 1e-4 and an absolute 1e-5 (MNIST: 85
SGD-momentum steps, read at most 4.8e-7 apart) or 1e-4 (ResNet-18: two
steps through 17 BatchNorms, the last over 8 values a channel; read at
most 1.7e-5 apart) of the largest magnitude of its tensor (at least 1):
float32 on both sides, contractions summed in other orders. The
launcher's counts (training steps and validation batches) equal the JAX
run's.

Also: ``models.mlp``/``models.lenet`` as the reference builds them (JSON,
shapes), and ``io.MNISTIter`` batch for batch against the reference's over
idx files the test writes (raw and ``.gz``, flat and not, 2 parts,
shuffled or not).
"""

import gzip
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)

import mxnet_tpu_torch as pmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
# (rtol, atol as a share of the tensor's largest magnitude, at least 1)
TOL = {"mlp": (1e-4, 1e-5), "lenet": (1e-4, 1e-5), "resnet18": (1e-4, 1e-4)}
CPU = pmx.cpu()

SCRIPTS = {
    "mlp": ["examples/train_mnist.py", "--synthetic", "1", "--network",
            "mlp"],
    "lenet": ["examples/train_mnist.py", "--synthetic", "1", "--network",
              "lenet"],
    "resnet18": ["examples/train_imagenet.py", "--network", "resnet",
                 "--num-layers", "18", "--image-shape", "3,32,32",
                 "--num-classes", "10", "--batch-size", "8",
                 "--num-examples", "16", "--kv-store", "device",
                 "--benchmark", "1"],
}
SYMBOLS = {
    "mlp": lambda m: m.models.mlp(num_classes=10),
    "lenet": lambda m: m.models.lenet(num_classes=10),
    "resnet18": lambda m: m.models.resnet(num_classes=10, num_layers=18,
                                          image_shape="3,32,32"),
}
DATA_SHAPE = {"mlp": (1, 784), "lenet": (1, 1, 28, 28),
              "resnet18": (1, 3, 32, 32)}

# each runner takes a JSON list of argument lists and runs them in turn;
# the port's first asks for the card the launcher defaults to and, on a
# machine without one, prints the error it must raise
PORT_RUNNER = (
    "import json, sys, torch\n"
    "from mxnet_tpu_torch.launch import main\n"
    "runs = json.loads(sys.argv[1])\n"
    "if not torch.cuda.is_available():\n"
    "    try:\n"
    "        main(['examples/train_mnist.py', '--synthetic', '1'])\n"
    "    except Exception as e:\n"
    "        print(json.dumps({'no_card': repr(e)}), flush=True)\n"
    "for args in runs:\n"
    "    main(args)\n")
JAX_RUNNER = (
    "import json, runpy, sys\n"
    "import numpy as np\n"
    "from mxnet_tpu import telemetry as tm\n"
    "for args in json.loads(sys.argv[1]):\n"
    "    tm.reset()\n"
    "    np.random.seed(int(args[1]))\n"
    "    sys.argv = args[2:]\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "    print(json.dumps({'launch': {\n"
    "        'fit_batches': tm.counter('fit.batches').value,\n"
    "        'score_batches': tm.histogram('score.dispatch').count}}),\n"
    "        flush=True)\n")


def _checkpoint(prefix, name):
    """Write ``<prefix>-symbol.json`` and ``<prefix>-0000.params``: the
    reference's symbol and seeded weights (He-normal, gamma in [0.5,
    1.5], small biases, BatchNorm statistics in range)."""
    sym = SYMBOLS[name](jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=DATA_SHAPE[name])
    rng = np.random.default_rng(SEED)
    args, auxs = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.uniform(-0.1, 0.1, s)
        args[n] = jmx.nd.array(v.astype(np.float32))
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.5, 1.5) if n.endswith("_var") else (-0.1, 0.1)
        auxs[n] = jmx.nd.array(rng.uniform(lo, hi, s).astype(np.float32))
    if name == "resnet18":
        for n, mean in _batch_means(args, auxs).items():
            auxs[f"{n}_moving_mean"] = jmx.nd.array(mean)
    jmx.model.save_checkpoint(prefix, 0, sym, args, auxs)


def _batch_means(args, auxs):
    """Each BatchNorm's channel means over the one batch ``--benchmark 1``
    trains on (``fit.py``'s SyntheticDataIter draws its labels, then its
    data, from the seeded global generator), by a training forward on the
    port's CPU path. The reference's training BatchNorm computes the
    variance about its moving mean, and its float32 gradient is only as
    good as that anchor is close to the batch mean (at random moving means
    its ResNet-18 gradients here stand up to 7 % off their float64 values,
    the port's 3e-6); a checkpoint anchored at the batch means is where
    both are accurate."""
    rs = np.random.RandomState(SEED)
    rs.randint(0, 10, [8])
    x = rs.uniform(-1, 1, (8,) + DATA_SHAPE["resnet18"][1:]).astype(
        np.float32)
    with pmx.NameManager():
        sym = SYMBOLS["resnet18"](pmx)
    nodes = json.loads(sym.tojson())["nodes"]
    bns = {n["name"]: nodes[n["inputs"][0][0]]["name"] for n in nodes
           if n["op"] == "BatchNorm"}
    internals = sym.get_internals()
    group = pmx.sym.Group([internals[f"{src}_output"]
                           for src in bns.values()])
    exe = group.simple_bind(CPU, data=x.shape, grad_req="null")
    for n, v in {**args, **auxs}.items():
        arrays = exe.arg_dict if n in exe.arg_dict else exe.aux_dict
        if n in arrays:
            arrays[n][:] = np.array(v.asnumpy())
    exe.forward(is_train=True, data=pmx.nd.array(x, ctx=CPU))
    return {bn: out.asnumpy().mean(axis=(0, 2, 3))
            for bn, out in zip(bns, exe.outputs)}


def _run(runner, runs, env):
    return subprocess.Popen(
        [sys.executable, "-c", runner, json.dumps(runs)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lines(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what}:\n{err[-4000:]}"
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")], err


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """Each script run by both packages from one checkpoint: ``{name:
    (port params, jax params, port counts, jax counts)}``, the port's log,
    and the error of the port's run without ``--cpu`` (none on a card)."""
    base = tmp_path_factory.mktemp("scripts")
    port_runs, jax_runs, prefixes = [], [], {}
    for name, argv in SCRIPTS.items():
        first = str(base / name / "ckpt")
        os.makedirs(os.path.dirname(first))
        _checkpoint(first, name)
        for side in ("port", "jax"):
            prefix = str(base / side / name / "ckpt")
            os.makedirs(os.path.dirname(prefix))
            for suffix in ("-symbol.json", "-0000.params"):
                shutil.copyfile(first + suffix, prefix + suffix)
            prefixes[name, side] = prefix
        tail = ["--model-prefix", None, "--load-epoch", "0",
                "--num-epochs", "1"]
        for side, runs, head in (("port", port_runs, ["--cpu"]),
                                 ("jax", jax_runs, [])):
            tail[1] = prefixes[name, side]
            runs.append(head + ["--seed", str(SEED)] + argv + list(tail))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [_run(PORT_RUNNER, port_runs, env),
             _run(JAX_RUNNER, jax_runs, env)]
    (port_lines, port_log), (jax_lines, _log) = (
        _lines(procs[0], "port"), _lines(procs[1], "jax"))
    port_counts = [x["launch"] for x in port_lines if "launch" in x]
    jax_counts = [x["launch"] for x in jax_lines if "launch" in x]
    out = {}
    for i, name in enumerate(SCRIPTS):
        params = [pmx.nd.load(f"{prefixes[name, side]}-0001.params")
                  for side in ("port", "jax")]
        out[name] = (*params, port_counts[i], jax_counts[i])
    no_card = [x["no_card"] for x in port_lines if "no_card" in x]
    return out, port_log, no_card


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_matches_reference_from_one_checkpoint(scripts, name):
    runs, _log, _no_card = scripts
    got, want, port_counts, jax_counts = runs[name]
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].asnumpy(), want[key].asnumpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL[name][0],
                                   atol=TOL[name][1] * scale, err_msg=key)
    assert port_counts["fit_batches"] == jax_counts["fit_batches"] > 0
    assert port_counts["score_batches"] == jax_counts["score_batches"]
    # the CPU path launches no kernel, and nothing imported jax
    assert not any(port_counts["launches"].values())
    assert port_counts["jax"] is False


def test_scripts_train_on_the_cpu_through_a_store(scripts):
    _runs, log, _no_card = scripts
    assert "Validation-accuracy" in log and "samples/sec" in log
    assert "kv_store='local'" in log and "kv_store='device'" in log


def test_launcher_without_cpu_needs_the_card(scripts):
    """Without ``--cpu`` the script's first array asks for ``gpu(0)``; on a
    machine without a card that raises, and nothing falls back to the
    CPU."""
    _runs, _log, no_card = scripts
    if torch.cuda.is_available():
        assert no_card == []
        return
    assert len(no_card) == 1 and "gpu(0) requested" in no_card[0], no_card


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_models_match_reference(name):
    with jmx.name.NameManager():
        jsym = SYMBOLS[name](jmx)
    with pmx.NameManager():
        psym = SYMBOLS[name](pmx)
    assert json.loads(psym.tojson()) == json.loads(jsym.tojson())
    assert psym.infer_shape(data=DATA_SHAPE[name]) == \
        jsym.infer_shape(data=DATA_SHAPE[name])


# --- MNISTIter -------------------------------------------------------------

def _write_idx(path, array):
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def idx_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (37, 28, 28))
    labels = rng.integers(0, 10, 37)
    files = {}
    for suffix in ("", ".gz"):
        img, lab = str(d / f"img{suffix}"), str(d / f"lab{suffix}")
        _write_idx(img, images)
        _write_idx(lab, labels)
        files[suffix] = (img, lab)
    return files


@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("parts,shuffle", [((1, 0), True), ((2, 1), False),
                                           ((2, 0), True)])
def test_mnist_iter_matches_reference(idx_files, suffix, flat, parts,
                                      shuffle):
    img, lab = idx_files[suffix]
    kw = dict(image=img, label=lab, batch_size=5, flat=flat, seed=3,
              shuffle=shuffle, num_parts=parts[0], part_index=parts[1])
    want = list(jmx.io.MNISTIter(**kw))
    got = list(pmx.io.MNISTIter(ctx=CPU, **kw))
    assert len(got) == len(want) == (37 // parts[0] + (parts[1] == 0)
                                     * (37 % parts[0] > 0)) // 5
    for g, w in zip(got, want):
        assert g.pad == w.pad == 0
        for ga, wa in zip(g.data + g.label, w.data + w.label):
            assert ga.context == CPU
            np.testing.assert_array_equal(ga.asnumpy(), wa.asnumpy())


def test_mnist_iter_reads_the_gz_beside_a_missing_raw_file(idx_files):
    img, lab = idx_files[".gz"]
    got = pmx.io.MNISTIter(image=img[:-3], label=lab[:-3], batch_size=4,
                           ctx=CPU, shuffle=False)
    want = jmx.io.MNISTIter(image=img[:-3], label=lab[:-3], batch_size=4,
                            shuffle=False)
    assert got.provide_data[0].shape == want.provide_data[0].shape == \
        (4, 1, 28, 28)
    np.testing.assert_array_equal(next(iter(got)).data[0].asnumpy(),
                                  next(iter(want)).data[0].asnumpy())
