"""sph_nca_tpu_torch.training — losses, sample pools, the trainer, the
optimizers and the feature extractors of the texture and CLIP losses.

Counterpart of ``sph_nca_tpu.training`` (its public names, in its order),
apart from two that name JAX machinery:

* ``bucket_steps`` rounds a rollout's length up to a static scan length;
  the port runs exactly the steps asked for, so it has no counterpart.
* ``normalize_grads`` is an optax gradient transformation; the port's
  trainer normalizes in place with ``trainer.normalize_grads_``, which is
  not the same callable and is not exported under that name.

  losses.py        MSE, OT (relaxed EMD over texture features) and CLIP
                   losses
  pool.py          the sample pools (``Pool`` on the host, ``DevicePool``)
  trainer.py       ``Trainer`` and the loss bundles
  optim.py         the JAX trainer's seven optimizers, as optax defines them
  features.py      Gabor and VGG19 texture features
  clip_encoder.py  CLIP's image tower; clip_text.py its text tower
"""

from .losses import (
    CLIPLossConfig,
    MSELossConfig,
    OTLossConfig,
    clip_loss,
    mse_loss,
    moment_loss,
    ot_feature_loss,
    ot_loss,
    overflow_penalty,
    pairwise_cos_distance,
    particles_to_image,
    relaxed_emd,
    rgba_with_margin,
    spherical_distance,
)
from .pool import Pool
from .trainer import (
    LossBundle,
    TrainConfig,
    Trainer,
    make_clip_bundle,
    make_mse_bundle,
    make_optimizer,
    make_ot_bundle,
    progressive_steps,
)

__all__ = [
    "CLIPLossConfig",
    "LossBundle",
    "MSELossConfig",
    "OTLossConfig",
    "Pool",
    "TrainConfig",
    "Trainer",
    "clip_loss",
    "make_clip_bundle",
    "make_mse_bundle",
    "make_optimizer",
    "make_ot_bundle",
    "moment_loss",
    "mse_loss",
    "ot_feature_loss",
    "ot_loss",
    "overflow_penalty",
    "pairwise_cos_distance",
    "particles_to_image",
    "progressive_steps",
    "relaxed_emd",
    "rgba_with_margin",
    "spherical_distance",
]
