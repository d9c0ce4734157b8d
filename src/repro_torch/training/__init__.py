from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_lr  # noqa: F401
from repro_torch.training.train import make_train_step, train_loop  # noqa: F401
