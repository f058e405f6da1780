"""DCGAN generator/discriminator (reference example/gan/dcgan.py); a copy
of ``mxnet_tpu/models/dcgan.py``."""

from .. import symbol as sym


def make_generator(ngf=64, nc=3, no_bias=True, fix_gamma=True, eps=1e-5 + 1e-12):
    """Generator: z (n, code, 1, 1) → image (n, nc, 64, 64)."""
    BatchNorm = sym.BatchNorm
    rand = sym.Variable("rand")

    g1 = sym.Deconvolution(rand, name="g1", kernel=(4, 4), num_filter=ngf * 8,
                           no_bias=no_bias)
    gbn1 = BatchNorm(g1, name="gbn1", fix_gamma=fix_gamma, eps=eps)
    gact1 = sym.Activation(gbn1, name="gact1", act_type="relu")

    g2 = sym.Deconvolution(gact1, name="g2", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf * 4, no_bias=no_bias)
    gbn2 = BatchNorm(g2, name="gbn2", fix_gamma=fix_gamma, eps=eps)
    gact2 = sym.Activation(gbn2, name="gact2", act_type="relu")

    g3 = sym.Deconvolution(gact2, name="g3", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf * 2, no_bias=no_bias)
    gbn3 = BatchNorm(g3, name="gbn3", fix_gamma=fix_gamma, eps=eps)
    gact3 = sym.Activation(gbn3, name="gact3", act_type="relu")

    g4 = sym.Deconvolution(gact3, name="g4", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ngf, no_bias=no_bias)
    gbn4 = BatchNorm(g4, name="gbn4", fix_gamma=fix_gamma, eps=eps)
    gact4 = sym.Activation(gbn4, name="gact4", act_type="relu")

    g5 = sym.Deconvolution(gact4, name="g5", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=nc, no_bias=no_bias)
    return sym.Activation(g5, name="gact5", act_type="tanh")


def make_discriminator(ndf=64, no_bias=True, fix_gamma=True, eps=1e-5 + 1e-12):
    """Discriminator: image (n, nc, 64, 64) → logistic real/fake loss."""
    BatchNorm = sym.BatchNorm
    data = sym.Variable("data")
    label = sym.Variable("label")

    d1 = sym.Convolution(data, name="d1", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf, no_bias=no_bias)
    dact1 = sym.LeakyReLU(d1, name="dact1", act_type="leaky", slope=0.2)

    d2 = sym.Convolution(dact1, name="d2", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 2, no_bias=no_bias)
    dbn2 = BatchNorm(d2, name="dbn2", fix_gamma=fix_gamma, eps=eps)
    dact2 = sym.LeakyReLU(dbn2, name="dact2", act_type="leaky", slope=0.2)

    d3 = sym.Convolution(dact2, name="d3", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 4, no_bias=no_bias)
    dbn3 = BatchNorm(d3, name="dbn3", fix_gamma=fix_gamma, eps=eps)
    dact3 = sym.LeakyReLU(dbn3, name="dact3", act_type="leaky", slope=0.2)

    d4 = sym.Convolution(dact3, name="d4", kernel=(4, 4), stride=(2, 2),
                         pad=(1, 1), num_filter=ndf * 8, no_bias=no_bias)
    dbn4 = BatchNorm(d4, name="dbn4", fix_gamma=fix_gamma, eps=eps)
    dact4 = sym.LeakyReLU(dbn4, name="dact4", act_type="leaky", slope=0.2)

    d5 = sym.Convolution(dact4, name="d5", kernel=(4, 4), num_filter=1,
                         no_bias=no_bias)
    d5 = sym.Flatten(d5)
    return sym.LogisticRegressionOutput(d5, label, name="dloss")
