"""The port's counter-based dropout: the ``dropout`` kernel's plain version,
the random key chain, the executor's keys, steps and serials, ``Dropout``
against the JAX package, and the LSTM language model with dropout,
``ZoneoutCell`` and the ``RNN`` op's dropout between layers held to the
reference in training by feeding the reference the port's masks.

The bits cannot equal JAX's (Philox against threefry), so every parity
test either runs where no bit is drawn (inference, ``p = 0``) or reads the
port's masks and hands them to the reference graph as inputs. Where the
loss is a deterministic function of the inputs (a fixed executor step),
the training gradients are checked by central differences in float64.

The card wrapper's cached keep probability equals ``float32(1 - p)``, and
its refusals run on stand-ins that report a CUDA device (``_OnCard``),
which the wrapper checks before any launch.

Tolerances: bit for bit where no arithmetic differs (identity, the mask
and its products); float32 rtol 1e-5 / atol 1e-6 for the language model,
``ZoneoutCell`` and the ``RNN`` op against the reference (the LSTM's
``exp``/``tanh`` and the products' sums in two libraries); float64 central
differences at eps 1e-6 to rtol 1e-6 / atol 1e-8.
"""

import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import random as prandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import dropout as dk
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops.registry import OpMode as POpMode
from mxnet_tpu_torch.symbol import Symbol as PSymbol

TOL = dict(rtol=1e-5, atol=1e-6)
FD_TOL = dict(rtol=1e-6, atol=1e-8)
KEY = 0x0123456789ABCDEF


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16, 8: torch.int64}[
        t.element_size()])


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = dk.philox4x32([torch.tensor([c], dtype=torch.int64)
                           for c in counter], key)
    assert tuple(int(w) for w in words) == want


def test_identity_at_p0_and_in_inference_bit_for_bit():
    """Inference, and training at ``p = 0``, return the input itself in
    both packages."""
    x = np.random.default_rng(0).standard_normal((4, 7)).astype(np.float32)
    for p, train in ((0.5, False), (0.0, True)):
        got = []
        for pkg in (jmx, pmx):
            sym = pkg.sym.Dropout(pkg.sym.Variable("x"), p=p, name="d")
            exe = sym.simple_bind(pkg.cpu(), x=x.shape, grad_req="null")
            exe.forward(is_train=train, x=x)
            got.append(exe.outputs[0].asnumpy())
        assert got[0].tobytes() == x.tobytes()
        assert got[1].tobytes() == x.tobytes()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_mask_values_products_and_gradient(p, dtype):
    """The mask holds exactly 0 and ``float32(1) / keep32`` (in x's dtype),
    ``y == x * mask`` exactly and ``dx == g * mask`` exactly."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(37, 11, generator=gen).to(dtype).requires_grad_(True)
    g = torch.randn(37, 11, generator=gen).to(dtype)
    op = preg.get("Dropout")
    (y, mask), _aux = op.apply([x], op.parse_params({"p": p}),
                               POpMode(is_train=True, rng=(KEY, 3, 1)))
    scale = (torch.tensor(1.0) / dk.keep32(p)).to(dtype)
    values = set(_bits(mask).unique().tolist())
    assert values <= {0, int(_bits(scale.reshape(1))[0])}
    assert len(values) == 2
    assert torch.equal(_bits(y.detach()), _bits(x.detach() * mask))
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(_bits(dx), _bits(g * mask))
    # the wrapper's plain version is the same function
    y2, m2 = dk.dropout(x.detach(), p, KEY, 3, 1)
    assert torch.equal(_bits(y2), _bits(y.detach()))
    assert torch.equal(_bits(m2), _bits(mask))


def test_divide_rounds_as_the_rnn_op():
    """``divide``: ``(x * kept) / keep32`` with no mask, equal element for
    element to the reference's ``x * bernoulli / keep`` (``defs_rnn.py``)
    evaluated by jnp on the same bits (a dropped negative element is -0
    here, where XLA selects +0); ``Dropout``'s ``x * (1 / keep32)`` rounds
    some elements otherwise, so the two modes are not interchangeable."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    y, mask = dk.dropout(x, 0.3, KEY, 1, 2, stream=1, divide=True)
    kept = dk.kept_plain(4096, 0.3, KEY, 1, 2, stream=1)
    assert mask is None
    want = torch.where(kept, x / dk.keep32(0.3), x * 0.0)
    assert torch.equal(_bits(y), _bits(want))
    ref = np.asarray(jax.numpy.asarray(x.numpy())
                     * jax.numpy.asarray(kept.numpy()) / (1.0 - 0.3))
    assert np.array_equal(ref, y.numpy())
    plain = dk.dropout(x, 0.3, KEY, 1, 2, stream=1)[0]
    assert not torch.equal(_bits(plain), _bits(y))


def test_keep_share():
    """Over 2**20 draws the kept share lies within 5 sigma of ``keep``."""
    n = 1 << 20
    for p in (0.1, 0.5, 0.9):
        share = dk.kept_plain(n, p, KEY, 1, 0).double().mean().item()
        sigma = ((1 - p) * p / n) ** 0.5
        assert abs(share - (1 - p)) < 5 * sigma, (p, share)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.0, 1.0])
def test_cached_keep_is_the_float32_of_one_minus_p(p):
    """The wrapper's cached keep probability is ``float32(1 - p)`` exactly,
    the value the keep test and the roundings read, first call and
    cached."""
    for _ in range(2):
        got = dk.keep32_value(p)
        assert isinstance(got, float)
        assert got == float(np.float32(1.0 - p)) == dk.keep32(p).item()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0: what the card wrapper checks
    before any launch."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["float64", "int32", "non-contiguous"])
def test_card_wrapper_refuses_what_the_kernel_does_not_take(case):
    x = {"float64": torch.zeros(8, dtype=torch.float64),
         "int32": torch.zeros(8, dtype=torch.int32),
         "non-contiguous": torch.zeros(8, 6)[:, :4]}[case]
    x = torch.Tensor._make_subclass(_OnCard, x)
    n0 = dk.LAUNCHES.value
    with pytest.raises(MXNetError, match="dropout: x must be a contiguous"):
        dk.dropout(x, 0.5, KEY, 1, 0)
    assert dk.LAUNCHES.value == n0


def test_bits_depend_on_key_step_serial_and_stream():
    args = dict(key=KEY, step=5, serial=2, stream=1)
    base = dk.kept_plain(4096, 0.5, **args)
    assert torch.equal(base, dk.kept_plain(4096, 0.5, **args))
    for name, other in (("key", KEY ^ (1 << 40)), ("step", 6),
                        ("serial", 3), ("stream", 0)):
        moved = dict(args, **{name: other})
        assert not torch.equal(base, dk.kept_plain(4096, 0.5, **moved)), name


def test_p_one_matches_the_reference():
    """At ``p = 1`` the reference divides by a zero ``keep``: NaN mask and
    output; the port matches it."""
    x = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    jop = jreg.get("Dropout")
    jouts, _ = jop.apply([jax.numpy.asarray(x)], jop.parse_params({"p": 1.0}),
                         JOpMode(is_train=True,
                                 rng=jax.random.PRNGKey(0)))
    pop = preg.get("Dropout")
    pouts, _ = pop.apply([torch.from_numpy(x)], pop.parse_params({"p": 1.0}),
                         POpMode(is_train=True, rng=(KEY, 1, 0)))
    for j, p in zip(jouts, pouts):
        assert np.isnan(np.asarray(j)).all()
        assert torch.isnan(p).all()


def test_random_state_round_trip():
    """``get_state`` is JSON and restores the key chain and every device
    generator; ``seed`` resets both."""
    prandom.seed(11)
    first = prandom.next_key()
    prandom.seed(11)
    assert prandom.next_key() == first
    pmx.random.uniform(shape=(3,), ctx=pmx.cpu())
    state = json.loads(json.dumps(prandom.get_state()))
    keys = [prandom.next_key() for _ in range(3)]
    draw = pmx.random.uniform(shape=(5,), ctx=pmx.cpu()).asnumpy()
    prandom.seed(99)
    prandom.set_state(state)
    assert [prandom.next_key() for _ in range(3)] == keys
    again = pmx.random.uniform(shape=(5,), ctx=pmx.cpu()).asnumpy()
    assert again.tobytes() == draw.tobytes()
    assert len({first, *keys}) == 4


def test_executor_keys_steps_and_serials():
    """Each executor takes a key at bind, each random node a serial in
    topological order, and every forward advances the step, training or
    not; the masks follow ``(key, step, serial)``."""
    data = pmx.sym.Variable("x")
    sym = pmx.sym.Dropout(pmx.sym.Dropout(data, p=0.5, name="a"), p=0.3,
                          name="b")
    x = np.ones((8, 16), np.float32)
    pmx.random.seed(5)
    exe = sym.simple_bind(pmx.cpu(), x=x.shape, grad_req="null")
    other = sym.simple_bind(pmx.cpu(), x=x.shape, grad_req="null")
    assert exe.rng_key != other.rng_key
    serials = sorted(exe.graph.rng_serial.values())
    assert serials == [0, 1]
    exe.forward(is_train=False, x=x)
    exe.forward(is_train=True, x=x)
    assert exe.rng_step == 2
    out = exe.outputs[0].asnumpy()
    a = dk.kept_plain(128, 0.5, exe.rng_key, 2, 0).reshape(8, 16)
    b = dk.kept_plain(128, 0.3, exe.rng_key, 2, 1).reshape(8, 16)
    scale = ((1 / dk.keep32(0.5)) * (1 / dk.keep32(0.3))).item()
    want = np.where((a & b).numpy(), scale, 0.0)
    np.testing.assert_allclose(out, want, rtol=1e-6)
    pmx.random.seed(5)
    again = sym.simple_bind(pmx.cpu(), x=x.shape, grad_req="null")
    assert again.rng_key == exe.rng_key


def _lm_weights(sym, shapes, rng):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def test_lm_with_dropout_against_the_reference_fed_the_masks():
    """One training step of a small LSTM language model with dropout (H =
    16, vocabulary 50, T = 5): the port draws its masks and returns them
    (the hidden outputs of the ``Dropout`` nodes that ``get_internals``
    lists); the reference runs the same graph with each ``Dropout``
    replaced by a product with a mask variable fed those masks. Outputs,
    loss and every parameter gradient agree."""
    hidden, vocab, seq, batch = 16, 50, 5, 4
    rng = np.random.default_rng(7)
    data = rng.integers(1, vocab, (batch, seq)).astype(np.float32)
    label = rng.integers(1, vocab, (batch, seq)).astype(np.float32)
    sym_gen, states = pmx.models.lstm_lm_sym_gen(
        num_hidden=hidden, num_embed=hidden, num_layers=2, vocab_size=vocab,
        dropout=0.5)
    sym = sym_gen(seq)[0]
    drops = [node for node, _i in sym.get_internals()._outputs
             if not node.is_variable and node.op.name == "Dropout"]
    drops.sort(key=lambda n: int(n.name[len("dropout"):]))
    assert len(drops) == seq
    group = pmx.sym.Group([sym] + [PSymbol([(n, 1)]) for n in drops])
    shapes = {"data": (batch, seq), "softmax_label": (batch, seq)}
    shapes.update({n: (batch, hidden) for n in states})
    weights = _lm_weights(sym, shapes, rng)
    req = {n: ("write" if n in weights else "null")
           for n in group.list_arguments()}
    exe = group.simple_bind(pmx.cpu(), grad_req=req, **shapes)
    exe.copy_params_from({k: pmx.nd.array(v, ctx=pmx.cpu())
                          for k, v in weights.items()},
                         allow_extra_params=True)
    exe.forward(is_train=True, data=data, softmax_label=label)
    exe.backward()
    outs = [o.asnumpy() for o in exe.outputs]
    masks = outs[1:]
    scale = (1 / dk.keep32(0.5)).item()
    for m in masks:
        assert set(np.unique(m)) <= {0.0, np.float32(scale)}

    # the reference graph, with a mask variable in place of each Dropout
    embed = jmx.sym.Embedding(jmx.sym.Variable("data"), input_dim=vocab,
                              output_dim=hidden, name="embed")
    l0 = jmx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l0_")
    outs0, _ = l0.unroll(seq, inputs=embed, merge_outputs=False)
    masked = [jmx.sym.elemwise_mul(o, jmx.sym.Variable(f"mask{t}"))
              for t, o in enumerate(outs0)]
    l1 = jmx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l1_")
    outs1, _ = l1.unroll(seq, inputs=masked, merge_outputs=True)
    pred = jmx.sym.Reshape(outs1, shape=(-1, hidden))
    pred = jmx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
    lab = jmx.sym.Reshape(jmx.sym.Variable("softmax_label"), shape=(-1,))
    ref = jmx.sym.SoftmaxOutput(pred, lab, name="softmax")
    mshapes = {f"mask{t}": (batch, hidden) for t in range(seq)}
    jreq = {n: ("write" if n in weights else "null")
            for n in ref.list_arguments()}
    jexe = ref.simple_bind(jmx.cpu(), grad_req=jreq, **shapes, **mshapes)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in weights.items()},
                          allow_extra_params=True)
    jexe.forward(is_train=True, data=data, softmax_label=label,
                 **{f"mask{t}": m for t, m in enumerate(masks)})
    jexe.backward()
    jprob = jexe.outputs[0].asnumpy()
    np.testing.assert_allclose(outs[0], jprob, **TOL)
    idx = label.reshape(-1).astype(int)
    loss = [-np.log(p[np.arange(len(idx)), idx]).mean()
            for p in (outs[0], jprob)]
    np.testing.assert_allclose(loss[0], loss[1], **TOL)
    for n in weights:
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(),
                                   jexe.grad_dict[n].asnumpy(), **TOL,
                                   err_msg=n)


def test_zoneout_in_training_against_the_reference_fed_the_masks():
    """A ``ZoneoutCell(LSTMCell)`` unrolled in training (H = 6, T = 4):
    the port draws each ``Dropout(ones_like(.))`` condition and returns it;
    the reference runs the same steps with each ``where`` taking a mask
    variable fed those conditions. Outputs, final states and the gradients
    of the input, the weights and the begin states agree."""
    hidden, seq, batch, cin = 6, 4, 3, 5
    rng = np.random.default_rng(31)
    cell = pmx.rnn.ZoneoutCell(pmx.rnn.LSTMCell(hidden, prefix="l0_"),
                               zoneout_outputs=0.3, zoneout_states=0.4)
    outs, finals = cell.unroll(seq, inputs=pmx.sym.Variable("data"),
                               merge_outputs=True)
    outs = pmx.sym.Group([outs] + list(finals))
    drops = [node for node, _i in outs.get_internals()._outputs
             if not node.is_variable and node.op.name == "Dropout"]
    drops.sort(key=lambda n: int(n.name[len("dropout"):]))
    assert len(drops) == 3 * seq  # the output, h and c at each step
    group = pmx.sym.Group([outs] + [PSymbol([(n, 1)]) for n in drops])
    shapes = {"data": (batch, seq, cin)}
    shapes.update({n: (batch, hidden) for n in outs.list_arguments()
                   if "begin_state" in n})
    arg_shapes, _, _ = outs.infer_shape(**shapes)
    values = {n: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for n, s in zip(outs.list_arguments(), arg_shapes)}
    heads = [rng.standard_normal(s).astype(np.float32) for s in
             [(batch, seq, hidden)] + [(batch, hidden)] * 2]
    exe = group.simple_bind(pmx.cpu(), grad_req="write", **shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    exe.forward(is_train=True)
    masks = [o.asnumpy() for o in exe.outputs[3:]]
    exe.backward([pmx.nd.array(h, ctx=pmx.cpu()) for h in heads]
                 + [pmx.nd.zeros(m.shape, ctx=pmx.cpu()) for m in masks])
    for m, p in zip(masks, [0.3, 0.4, 0.4] * seq):
        assert set(np.unique(m)) == {0.0, (1 / dk.keep32(p)).item()}

    # the reference: ZoneoutCell's steps with a mask variable per Dropout
    l0 = jmx.rnn.LSTMCell(num_hidden=hidden, prefix="l0_")
    states = [jmx.sym.Variable("l0_begin_state_0"),
              jmx.sym.Variable("l0_begin_state_1")]
    prev, steps, mshapes = None, [], {}

    def cond(k):
        mshapes[f"mask{k}"] = (batch, hidden)
        return jmx.sym.Variable(f"mask{k}")

    for t in range(seq):
        new_out, new_states = l0(jmx.sym.Variable(f"x{t}"), states)
        old = prev if prev is not None else jmx.sym.zeros_like(new_out)
        prev = jmx.sym.where(cond(3 * t), new_out, old)
        states = [jmx.sym.where(cond(3 * t + 1 + k), new, old)
                  for k, (new, old) in enumerate(zip(new_states, states))]
        steps.append(prev)
    ref = jmx.sym.Group([jmx.sym.stack(*steps, axis=1)] + states)
    feed = {f"x{t}": values["data"][:, t] for t in range(seq)}
    feed.update({n: v for n, v in values.items() if n != "data"})
    jreq = {n: ("null" if n.startswith("mask") else "write")
            for n in ref.list_arguments()}
    jexe = ref.simple_bind(jmx.cpu(), grad_req=jreq,
                           **{n: v.shape for n, v in feed.items()}, **mshapes)
    jexe.forward(is_train=True, **feed,
                 **{f"mask{k}": m for k, m in enumerate(masks)})
    jexe.backward([jmx.nd.array(h) for h in heads])
    for got, want in zip(exe.outputs[:3], jexe.outputs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    jdata = np.stack([jexe.grad_dict[f"x{t}"].asnumpy() for t in range(seq)],
                     axis=1)
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(), jdata, **TOL)
    for n in values:
        if n != "data":
            np.testing.assert_allclose(exe.grad_dict[n].asnumpy(),
                                       jexe.grad_dict[n].asnumpy(), **TOL,
                                       err_msg=n)


def _rnn_layer_slices(num_layers, dirs, cin, hidden, gates=4):
    """Index arrays that cut the ``RNN`` op's flat parameters (all weights,
    layer by layer and direction by direction, then all biases) into the
    flat parameters of one one-layer op per layer."""
    weights, p = [], 0
    for layer in range(num_layers):
        li = cin if layer == 0 else hidden * dirs
        n = dirs * (gates * hidden * li + gates * hidden * hidden)
        weights.append(np.arange(p, p + n))
        p += n
    out = []
    for layer in range(num_layers):
        n = dirs * 2 * gates * hidden
        out.append(np.concatenate([weights[layer], np.arange(p, p + n)]))
        p += n
    return out


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_dropout_in_training_against_the_reference_fed_the_masks(
        bidirectional):
    """The ``RNN`` op (lstm, 2 layers, ``p = 0.3``, so that ``keep`` is no
    power of two) in training: the port draws layer 0's mask from the
    node's ``(key, step, serial)`` with ``stream = 1``; the reference runs
    two one-layer ``RNN`` ops with ``x * kept / keep`` between them, fed
    those bits. Outputs, final states and the gradients of the data, the
    parameters and both begin states agree."""
    seq, batch, cin, hidden, p = 5, 3, 4, 6, 0.3
    dirs = 2 if bidirectional else 1
    rng = np.random.default_rng(32)
    sym = pmx.sym.RNN(pmx.sym.Variable("data"), state_size=hidden,
                      num_layers=2, mode="lstm", bidirectional=bidirectional,
                      p=p, state_outputs=True, name="rnn")
    shapes = {"data": (seq, batch, cin)}
    arg_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    values = {n: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)}
    heads = [rng.standard_normal(s).astype(np.float32) for s in out_shapes]
    exe = sym.simple_bind(pmx.cpu(), grad_req="write", **shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    exe.forward(is_train=True)
    exe.backward([pmx.nd.array(h, ctx=pmx.cpu()) for h in heads])
    (serial,) = exe.graph.rng_serial.values()
    kept = dk.kept_plain(seq * batch * hidden * dirs, p, exe.rng_key,
                         exe.rng_step, serial, stream=1)
    kept = kept.numpy().reshape(seq, batch, hidden * dirs).astype(np.float32)
    assert 0 < kept.mean() < 1

    # the reference: one one-layer op a layer, the mask fed between them
    cuts = _rnn_layer_slices(2, dirs, cin, hidden)
    x = jmx.sym.Variable("data")
    finals = []
    for layer in range(2):
        x = jmx.sym.RNN(x, jmx.sym.Variable(f"par{layer}"),
                        jmx.sym.Variable(f"state{layer}"),
                        jmx.sym.Variable(f"cell{layer}"), state_size=hidden,
                        num_layers=1, mode="lstm",
                        bidirectional=bidirectional, state_outputs=True,
                        name=f"ref{layer}")
        finals.append((x[1], x[2]))
        x = x[0]
        if layer == 0:
            x = x * jmx.sym.Variable("kept") / (1.0 - p)
    ref = jmx.sym.Group([x,
                         jmx.sym.concat(finals[0][0], finals[1][0], dim=0),
                         jmx.sym.concat(finals[0][1], finals[1][1], dim=0)])
    feed = {"data": values["data"], "kept": kept}
    for layer in range(2):
        rows = slice(layer * dirs, (layer + 1) * dirs)
        feed[f"par{layer}"] = values["rnn_parameters"][cuts[layer]]
        feed[f"state{layer}"] = values["rnn_state"][rows]
        feed[f"cell{layer}"] = values["rnn_state_cell"][rows]
    jreq = {n: ("null" if n == "kept" else "write")
            for n in ref.list_arguments()}
    jexe = ref.simple_bind(jmx.cpu(), grad_req=jreq,
                           **{n: v.shape for n, v in feed.items()})
    jexe.forward(is_train=True, **feed)
    jexe.backward([jmx.nd.array(h) for h in heads])
    for got, want in zip(exe.outputs, jexe.outputs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    jg = {n: a.asnumpy() for n, a in jexe.grad_dict.items() if a is not None}
    params = np.empty_like(values["rnn_parameters"])
    for layer in range(2):
        params[cuts[layer]] = jg[f"par{layer}"]
    want = {"data": jg["data"], "rnn_parameters": params,
            "rnn_state": np.concatenate([jg["state0"], jg["state1"]]),
            "rnn_state_cell": np.concatenate([jg["cell0"], jg["cell1"]])}
    for n, w in want.items():
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), w, **TOL,
                                   err_msg=n)


def _fd_check(exe, name, head, rng, coords=8, eps=1e-6):
    """Central differences of ``sum(out * head)`` in ``name`` against the
    executor's gradient, at a fixed step (each forward sets it back)."""
    arr = exe.arg_dict[name]

    def loss():
        exe.rng_step = 0
        exe.forward(is_train=True)
        return float((exe.outputs[0].asnumpy() * head).sum())

    exe.rng_step = 0
    exe.forward(is_train=True)
    exe.backward([pmx.nd.array(head, ctx=pmx.cpu(), dtype="float64")])
    grad = exe.grad_dict[name].asnumpy().reshape(-1)
    flat = arr._data.view(-1)
    for i in rng.choice(flat.numel(), coords, replace=False):
        keep = flat[i].item()
        flat[i] = keep + eps
        up = loss()
        flat[i] = keep - eps
        down = loss()
        flat[i] = keep
        np.testing.assert_allclose(grad[i], (up - down) / (2 * eps),
                                   **FD_TOL)


@pytest.mark.parametrize("cell", ["dropout", "zoneout"])
def test_cells_train_with_finite_difference_gradients(cell):
    """DropoutCell and ZoneoutCell in training, float64: at a fixed step
    the loss is a deterministic function of the inputs, and the gradient
    of the input agrees with central differences."""
    rng = np.random.default_rng(21)
    stack = pmx.rnn.SequentialRNNCell()
    if cell == "dropout":
        stack.add(pmx.rnn.LSTMCell(6, prefix="l0_"))
        stack.add(pmx.rnn.DropoutCell(0.4, prefix="d0_"))
        stack.add(pmx.rnn.LSTMCell(6, prefix="l1_"))
    else:
        stack.add(pmx.rnn.ZoneoutCell(pmx.rnn.LSTMCell(6, prefix="l0_"),
                                      zoneout_outputs=0.3,
                                      zoneout_states=0.4))
    outs, _ = stack.unroll(4, inputs=pmx.sym.Variable("data"),
                           merge_outputs=True)
    shapes = {"data": (3, 4, 5)}
    shapes.update({n: (3, 6) for n in outs.list_arguments()
                   if "begin_state" in n})
    exe = outs.simple_bind(pmx.cpu(), grad_req="write",
                           type_dict={n: "float64" for n in
                                      outs.list_arguments()}, **shapes)
    for n, a in exe.arg_dict.items():
        a[:] = rng.standard_normal(a.shape) * 0.5
    head = rng.standard_normal((3, 4, 6))
    _fd_check(exe, "data", head, rng)
    _fd_check(exe, [n for n in exe.arg_dict if n.endswith("h2h_weight")][0],
              head, rng)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_dropout_trains_with_finite_difference_gradients(
        bidirectional):
    """The ``RNN`` op's dropout between layers in training, float64: the
    backward, which draws the same bits again on the gradient, agrees with
    central differences in the data and the parameters; one layer's output
    is dropped (divide rounding: ``x * kept / keep``)."""
    rng = np.random.default_rng(22)
    sym = pmx.sym.RNN(pmx.sym.Variable("data"), state_size=4, num_layers=2,
                      mode="lstm", bidirectional=bidirectional, p=0.5,
                      name="rnn")
    shapes = {"data": (3, 2, 5)}
    arg_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    exe = sym.simple_bind(pmx.cpu(), grad_req="write",
                          type_dict={n: "float64" for n in
                                     sym.list_arguments()}, **shapes)
    for n, a in exe.arg_dict.items():
        a[:] = rng.standard_normal(a.shape) * 0.5
    head = rng.standard_normal(out_shapes[0])
    _fd_check(exe, "data", head, rng)
    _fd_check(exe, "rnn_parameters", head, rng, coords=12)
    # the training output differs from the inference one: a mask fired
    exe.rng_step = 0
    exe.forward(is_train=True)
    train = exe.outputs[0].asnumpy()
    exe.forward(is_train=False)
    assert not np.allclose(train, exe.outputs[0].asnumpy())


def test_rnn_op_with_dropout_at_inference_matches_the_reference():
    """At inference ``p`` draws nothing: the op with ``p = 0.5`` gives the
    reference's outputs."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, 2, 5)).astype(np.float32)
    got = []
    for pkg in (jmx, pmx):
        sym = pkg.sym.RNN(pkg.sym.Variable("data"), state_size=4,
                          num_layers=2, mode="lstm", p=0.5, name="rnn")
        exe = sym.simple_bind(pkg.cpu(), grad_req="null", data=x.shape)
        for n, a in sorted(exe.arg_dict.items()):
            if n != "data":
                a[:] = np.random.default_rng(len(n)).standard_normal(
                    a.shape).astype(np.float32) * 0.5
        exe.forward(is_train=False, data=x)
        got.append(exe.outputs[0].asnumpy())
    np.testing.assert_allclose(got[1], got[0], **TOL)


def test_lm_with_dropout_fits_on_the_cpu():
    """``lstm_lm_sym_gen(dropout=0.5)`` trains by ``BucketingModule.fit``
    on the CPU: finite perplexity that falls over three epochs."""
    rs = np.random.RandomState(0)
    sents = [[(s + i) % 29 + 1 for i in range(rs.choice([4, 8]))]
             for s in rs.randint(1, 29, 64)]
    it = pmx.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8],
                                    invalid_label=0, ctx=pmx.cpu())
    sym_gen, states = pmx.models.lstm_lm_sym_gen(
        num_hidden=16, num_embed=16, num_layers=2, vocab_size=31,
        dropout=0.5)
    pmx.random.seed(0)
    mod = pmx.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  state_names=states, context=pmx.cpu())
    metric = pmx.metric.Perplexity(0)
    epochs = []
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.05},
            initializer=pmx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=3,
            epoch_end_callback=lambda *_a: epochs.append(metric.get()[1]))
    assert np.isfinite(epochs).all() and epochs[-1] < epochs[0]
