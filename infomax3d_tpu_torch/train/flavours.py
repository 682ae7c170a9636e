"""The steps of the contrastive trainer's other flavours (port of the JAX
package's `SelfSupervisedAlternatingTrainer`, `NoisyNegativesTrainer` and
`PhilosophyTrainer` loss functions and steps, infomax3d_tpu/train/
trainer.py): each is `PretrainStep`'s forward of the 2D and 3D models
under the training recipe, with its own loss and backward.

* `AlternatingStep`: on even optimizer steps the 2D side learns against
  the detached 3D side; on odd steps the 3D side learns and the loss takes
  its arguments swapped.  The detached model gets zero gradients, so Adam
  still steps on it, as on JAX's zero gradients.
* `NoisyNegativesStep`: the 3D model also reads noised copies of the 3D
  view (`noised_distances_collate`); their embeddings are appended to the
  3D side, for `NTXentExtraNegatives` to take as extra negatives.  The
  second 3D forward continues the first's running statistics.  Under a
  data-parallel group the 3D side is gathered block by block, so the
  global [z2; z_noisy] is the concatenated batch's (the JAX package's
  `CrossDeviceLoss` gathers [z2_r; zn_r] rank by rank, which pairs a
  rank's 2D rows with another rank's noised rows as positives).
* `PhilosophyStep`: the critic reconstructs the 3D embedding; the peasant
  loss (the contrastive loss) trains the 2D model, the philosopher loss
  (peasant minus critic loss) the 3D model and the critic loss the
  critic, each through its own optimizer.  JAX differentiates three
  forwards with the same randomness and keeps the first's running
  statistics; here one forward runs (its statistics move once) and each
  loss is differentiated over its own model's parameters only.
"""
from __future__ import annotations

from typing import Optional

import torch

from infomax3d_tpu_torch.parallel.context import data_parallel_group
from infomax3d_tpu_torch.train.optim import OptimizerSet
from infomax3d_tpu_torch.train.precision import cast_batch, forward_in
from infomax3d_tpu_torch.train.remat import using_remat
from infomax3d_tpu_torch.train.pretrain import (PretrainStep, loss_kwargs,
                                                noise_kw)
from infomax3d_tpu_torch.utils.spans import span


class AlternatingStep(PretrainStep):
    """`PretrainStep` whose loss alternates sides with the parity `even`
    of the optimizer's step count (JAX ``state.step``; step 0 is even)."""

    def loss(self, g2, g3, noise=None, even: bool = True):
        z1, z2 = self.outputs(g2, g3, noise)
        kw = loss_kwargs(self.loss_fn, g2)
        if even:
            loss = self.loss_fn(z1, z2.detach(), **kw)
        else:
            loss = self.loss_fn(z2, z1.detach(), **kw)
        return loss, (z1, z2)


class NoisyNegativesStep(PretrainStep):
    """`PretrainStep` over the 2D view, the 3D view and its noised copy
    (one copy: the JAX trainer reads a single `noisy3d` batch)."""

    Z2_BLOCKS = 2           # the 3D side [z2; z_noisy]

    def prepare(self, g2, g3, noisy):
        g2, g3 = super().prepare(g2, g3)
        return g2, g3, cast_batch(noisy.to(self.device), self.compute_dtype)

    def loss(self, g2, g3, noisy, noise=None):
        """(loss, (z1, [z2; z_noisy])), float32."""
        z1, z2 = self.outputs(g2, g3, noise)
        zn = forward_in(self.model3d, self.compute_dtype, noisy,
                        **noise_kw(noise))
        z2 = torch.cat([z2, zn], dim=0)
        kw = loss_kwargs(self.loss_fn, g2)
        if data_parallel_group() is not None:
            kw["z2_blocks"] = self.Z2_BLOCKS
        return self.loss_fn(z1, z2, **kw), (z1, z2)


class PhilosophyStep(PretrainStep):
    """The three-player step (module docstring).  `optimizer` is an
    `OptimizerSet` keyed ``model``, ``model3d``, ``critic``; `critic_loss`
    maps (z2, reconstruction) to a scalar and is logged under its class
    name (`critic_loss_name`)."""

    @classmethod
    def from_modules(cls, model: torch.nn.Module, model3d: torch.nn.Module,
                     critic: torch.nn.Module, device: torch.device,
                     compute_dtype: Optional[torch.dtype], loss_fn,
                     critic_loss, optimizer: Optional[OptimizerSet] = None
                     ) -> "PhilosophyStep":
        step = super().from_modules(model, model3d, device, compute_dtype,
                                    loss_fn, optimizer)
        step.critic = critic.to(step.device).train()
        step.critic_loss = critic_loss
        step.critic_loss_name = type(critic_loss).__name__
        return step

    def named_parameters(self):
        yield from super().named_parameters()
        for n, p in self.critic.named_parameters():
            yield f"critic.{n}", p

    def loss(self, g2, g3, noise=None):
        """(peasant loss, (z1, z2, {"philosopher_loss", critic loss}))
        under the recipe; the critic reads z2 in the compute dtype, as the
        JAX trainer casts its input."""
        z1, z2 = self.outputs(g2, g3, noise)
        dt = self.compute_dtype
        recon = forward_in(self.critic, dt, z2 if dt is None else z2.to(dt),
                           **noise_kw(noise))
        critic_loss = self.critic_loss(z2, recon)
        peasant = self.loss_fn(z1, z2, **loss_kwargs(self.loss_fn, g2))
        return peasant, (z1, z2, {"philosopher_loss": peasant - critic_loss,
                                  self.critic_loss_name: critic_loss})

    def loss_and_grads(self, *batches, return_outputs: bool = False, **kw):
        """One forward; the peasant loss's gradient over the 2D model, the
        philosopher loss's over the 3D model, the critic loss's over the
        critic (zero where a loss does not reach a parameter)."""
        self.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"), using_remat(self.remat):
            peasant, out = self.loss(*batches, **kw)
        losses = {"model": peasant,
                  "model3d": out[2]["philosopher_loss"],
                  "critic": out[2][self.critic_loss_name]}
        keys = list(self.optimizer.optimizers)
        with span("step.backward"):
            for i, key in enumerate(keys):
                params = [p for g in
                          self.optimizer.optimizers[key].param_groups
                          for p in g["params"]]
                torch.autograd.backward(losses[key], inputs=params,
                                        retain_graph=i < len(keys) - 1)
                self.fill_missing_grads(params)
        if return_outputs:
            return peasant.detach(), (out[0].detach(), out[1].detach(),
                                      {k: v.detach()
                                       for k, v in out[2].items()})
        return peasant.detach()
