"""Optimizers, schedules and gradient compression of the training path
(the port of the reference's `repro/optim`)."""
from repro_torch.optim.adamw import (AdafactorConfig, AdamWConfig,
                                     adafactor_init, adafactor_update,
                                     adamw_init, adamw_update,
                                     make_optimizer)
from repro_torch.optim.schedules import (cosine_with_warmup,
                                         linear_warmup_constant)

__all__ = ["AdafactorConfig", "AdamWConfig", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update",
           "make_optimizer", "cosine_with_warmup", "linear_warmup_constant"]
