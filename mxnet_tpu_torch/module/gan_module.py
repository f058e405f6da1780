"""GANModule — the alternating DCGAN G/D training step.

Counterpart of ``mxnet_tpu/module/gan_module.py`` (reference MXNet
``example/gan/dcgan.py``): two Modules trained adversarially, the
discriminator D on real and generated images, the generator G through D's
gradient with respect to its image input.

Each step keeps the reference ordering (``mxnet_tpu/module/gan_module.py``
:240-306):

1. G forward on the latents;
2. D on the fake images with label 0, then on the real ones with label 1,
   the BatchNorm statistics advancing through both;
3. D's update on the summed gradients of the two passes;
4. D's third pass, fake with label 1, through the updated D (its parameter
   gradients are computed and left unread, as in the reference);
5. G's backward with D's input gradient as its head gradient;
6. G's update.

The JAX package runs a window of K steps as one jitted ``lax.scan``
program. Here :meth:`GANModule.train_window` runs the K steps as a host
loop over the two executors: the latents are drawn on the card from the
port's seeded generator (or taken from ``latents=``, the parity hook), D
reads the fake images as a fresh leaf detached from G's recorded graph,
which survives D's three passes until G's backward, and the optimizers run
their multi-tensor kernels (``adam_multi``) or, for an optimizer
without one, the parameter-by-parameter update. Capturing a whole window as
one CUDA graph is a later performance change (``ROADMAP.md``,
"Performance, after the benchmark").
:meth:`GANModule._serial_window` is the reference's imperative loop through
the Module API, the parity baseline. Both return a :class:`WindowBoundary`
holding the last step's real-pass D outputs, read before D's update.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import random as _random
from .. import telemetry as _tm
from ..base import MXNetError
from ..initializer import Normal
from ..io import DataBatch
from ..ndarray import NDArray
from .module import Module, WindowBoundary


def _as_tensor(x):
    return x._data if isinstance(x, NDArray) else torch.as_tensor(
        np.asarray(x))


class GANModule:
    """Two adversarially-trained Modules behind one alternating step.

    Parameters
    ----------
    generator : Symbol
        Maps latent ``rand_name`` (n, code, 1, 1) to an image.
    discriminator : Symbol
        Loss-headed real/fake classifier over ``data_name``/``label_name``.
    context : Context
    batch_size : int
    code_shape : tuple
        Per-sample latent shape, e.g. ``(100, 1, 1)``.
    data_shape : tuple
        Per-sample image shape, e.g. ``(3, 64, 64)``.
    """

    def __init__(self, generator, discriminator, context=None, batch_size=64,
                 code_shape=(100, 1, 1), data_shape=(3, 64, 64),
                 rand_name="rand", data_name="data", label_name="label",
                 logger=logging):
        self._rand_name = rand_name
        self._data_name = data_name
        self._label_name = label_name
        self.batch_size = batch_size
        self.code_shape = tuple(code_shape)
        self.data_shape = tuple(data_shape)
        self.logger = logger
        self.mod_g = Module(generator, data_names=(rand_name,),
                            label_names=None, logger=logger, context=context)
        self.mod_d = Module(discriminator, data_names=(data_name,),
                            label_names=(label_name,), logger=logger,
                            context=context)
        self._labels = None  # (zeros, ones) of D's label on its device

    # ------------------------------------------------------------------
    def bind(self):
        bs = self.batch_size
        self.mod_g.bind(data_shapes=[(self._rand_name,
                                      (bs,) + self.code_shape)])
        # inputs_need_grad: G trains through D's gradient wrt its image input
        self.mod_d.bind(data_shapes=[(self._data_name,
                                      (bs,) + self.data_shape)],
                        label_shapes=[(self._label_name, (bs,))],
                        inputs_need_grad=True)
        return self

    def init_params(self, initializer=None, force_init=False):
        initializer = initializer or Normal(0.02)
        self.mod_g.init_params(initializer=initializer, force_init=force_init)
        self.mod_d.init_params(initializer=initializer, force_init=force_init)
        return self

    def init_optimizer(self, optimizer="adam",
                       optimizer_params=(("learning_rate", 0.0002),
                                         ("beta1", 0.5)),
                       force_init=False):
        for mod in (self.mod_g, self.mod_d):
            mod.init_optimizer(optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        return self

    # ------------------------------------------------------------------
    def _latent_steps(self, latents, n_steps):
        """``latents`` (listed per step, or stacked, or one draw when
        ``n_steps`` is 1) as one tensor per step."""
        if isinstance(latents, (list, tuple)):
            steps = [_as_tensor(x) for x in latents]
        else:
            stack = _as_tensor(latents)
            if stack.dim() == len(self.code_shape) + 1:
                stack = stack[None]
            steps = list(stack)
        if len(steps) != n_steps:
            raise MXNetError(f"latents: expected {n_steps} per-step draws, "
                             f"got {len(steps)}")
        return steps

    def train_window(self, real_batch, n_steps=1, batches=None, latents=None):
        """Run ``n_steps`` G/D train steps.

        ``real_batch`` alone trains every iteration on that batch;
        ``batches`` (list of real images or DataBatch, overrides
        ``n_steps``) trains iteration ``i`` on ``batches[i]``. ``latents``
        (per-step noise, stacked or listed) replaces the sampler — the
        parity-test hook. Returns a :class:`WindowBoundary` publishing the
        last iteration's real-pass D outputs (pre-update, the reference's
        metric read), or None for an empty ``batches``.
        """
        if batches is not None:
            if not batches:
                return None
            n_steps = len(batches)
        else:
            batches = [real_batch] * n_steps
        steps = None if latents is None \
            else self._latent_steps(latents, n_steps)
        outs = None
        for i, b in enumerate(batches):
            real = b.data[0] if isinstance(b, DataBatch) else b
            outs = self._step(_as_tensor(real),
                              None if steps is None else steps[i])
        _tm.counter("gan.window").inc()
        return WindowBoundary(n_steps, outs)

    def _step(self, real, z):
        """One G/D step on the executors; returns D's real-pass outputs."""
        g_exe = self.mod_g._exec_group._exec
        d_exe = self.mod_d._exec_group._exec
        rand = g_exe.arg_dict[self._rand_name]._data
        if z is None:
            rand.normal_(generator=_random.generator(rand.device))
        else:
            rand.copy_(z)
        g_exe.forward(is_train=True)
        fake = g_exe.outputs[0]._data  # detached: a fresh leaf for D
        if self._labels is None:
            lab = d_exe.arg_dict[self._label_name]._data
            self._labels = (torch.zeros_like(lab), torch.ones_like(lab))
        zeros, ones = self._labels
        data, label = self._data_name, self._label_name
        names = [n for n in self.mod_d._param_names
                 if d_exe.grad_req.get(n, "null") != "null"]

        d_exe.forward(is_train=True, **{data: fake, label: zeros})
        d_exe.backward()
        # bind() asks for "write" gradients, new tensors each backward: hold
        # the fake pass's, and add them into the real pass's in place (the
        # tensors the update then reads)
        fake_grads = [d_exe.grad_dict[n]._data for n in names]
        d_exe.forward(is_train=True, **{data: real, label: ones})
        d_exe.backward()
        for n, gf in zip(names, fake_grads):
            d_exe.grad_dict[n]._data.add_(gf)
        outs = [o._data for o in d_exe.outputs]
        self.mod_d.update()

        d_exe.forward(is_train=True, **{data: fake, label: ones})
        d_exe.backward()
        g_exe.backward([d_exe.grad_dict[data]])
        self.mod_g.update()
        return outs

    # ------------------------------------------------------------------
    def _serial_window(self, batches, latents):
        """The reference imperative loop (example/gan/dcgan.py ordering)
        through the Module API — the parity baseline of
        :meth:`train_window`. Without ``latents`` it draws the noise with
        ``nd.random_normal`` on G's context (the reference draws on the
        default context and copies)."""
        from .. import ndarray as nd

        bs = self.batch_size
        mod_g, mod_d = self.mod_g, self.mod_d
        ctx = mod_g._context[0]
        outs = None
        for i, b in enumerate(batches):
            real = b.data[0] if isinstance(b, DataBatch) else b
            if not isinstance(real, NDArray):
                real = nd.array(real, ctx=ctx)
            if latents is not None:
                noise = latents[i]
                if not isinstance(noise, NDArray):
                    noise = nd.array(noise, ctx=ctx)
            else:
                noise = nd.random_normal(
                    loc=0, scale=1, shape=(bs,) + self.code_shape, ctx=ctx)
            mod_g.forward(DataBatch(data=[noise], label=None), is_train=True)
            fake = mod_g.get_outputs()[0]

            mod_d.forward(DataBatch(data=[fake],
                                    label=[nd.zeros((bs,), ctx=ctx)]),
                          is_train=True)
            mod_d.backward()
            grads_fake = [[g.copy() if g is not None else None for g in gl]
                          for gl in mod_d._exec_group.grad_arrays]
            mod_d.forward(DataBatch(data=[real],
                                    label=[nd.ones((bs,), ctx=ctx)]),
                          is_train=True)
            mod_d.backward()
            for gl, gf in zip(mod_d._exec_group.grad_arrays, grads_fake):
                if gl[0] is not None:
                    gl[0] += gf[0]
            mod_d.update()
            outs = [o._data for o in mod_d.get_outputs()]

            mod_d.forward(DataBatch(data=[fake],
                                    label=[nd.ones((bs,), ctx=ctx)]),
                          is_train=True)
            mod_d.backward()
            diff_d = mod_d.get_input_grads()
            mod_g.backward(diff_d)
            mod_g.update()
        return WindowBoundary(len(batches), outs)
