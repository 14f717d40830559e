from .train_lib import cross_entropy, make_loss_fn, make_train_step, seal_train_step

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step", "seal_train_step"]
