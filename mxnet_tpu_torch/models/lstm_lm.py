"""Bucketed LSTM language model (reference example/rnn/lstm_bucketing.py;
a copy of ``mxnet_tpu/models/lstm_lm.py``)."""

from .. import symbol as sym
from .. import rnn as rnn_mod


def lstm_lm_sym_gen(num_hidden=200, num_layers=2, num_embed=200,
                    vocab_size=10000, dropout=0.0):
    """Return a ``sym_gen(seq_len)`` for BucketingModule plus the list of
    begin-state names to pass as Module ``state_names``."""
    stack = rnn_mod.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn_mod.LSTMCell(num_hidden=num_hidden, prefix=f"lstm_l{i}_"))
        if dropout > 0 and i < num_layers - 1:
            stack.add(rnn_mod.DropoutCell(dropout, prefix=f"lstm_d{i}_"))

    state_names = []
    for i, info in enumerate(stack.state_info):
        pass  # names assigned at unroll time; computed below

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(
            data, input_dim=vocab_size, output_dim=num_embed, name="embed"
        )
        stack.reset()
        outputs, states = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label_flat = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(pred, label_flat, name="softmax")
        return pred, ("data",), ("softmax_label",)

    # materialise state names once (unroll assigns begin_state_<i>)
    probe, _, _ = sym_gen(2)
    state_names = [
        n for n in probe.list_arguments() if "begin_state" in n
    ]
    return sym_gen, state_names


def lstm_lm_serving_sym_gen(num_hidden=200, num_layers=2, num_embed=200,
                            vocab_size=10000):
    """Inference-side ``sym_gen(seq_len)`` for seq-len-bucketed SERVING:
    the same stacked LSTM LM but label-free and batch-major — output
    ``(batch, seq_len, vocab)`` logits, so the serving batcher can
    scatter rows back per request. Pass to
    ``ModelServer(sym_gen=..., config=ServingConfig(seq_buckets=...))``
    with ``input_types={"data": "int32"}``."""
    stack = rnn_mod.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn_mod.LSTMCell(num_hidden=num_hidden,
                                   prefix=f"lstm_l{i}_"))

    def sym_gen(seq_len):
        data = sym.Variable("data")
        embed = sym.Embedding(
            data, input_dim=vocab_size, output_dim=num_embed, name="embed"
        )
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        pred = sym.Reshape(pred, shape=(-1, seq_len, vocab_size),
                           name="logits")
        return pred, ("data",), ()

    return sym_gen
