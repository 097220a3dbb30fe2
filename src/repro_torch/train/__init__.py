"""Training: the loss, its gradients and the optimizer step, as the JAX
package's ``train``."""
from .steps import (
    AUX_LOSS_COEF,
    chunked_xent,
    loss_fn,
    make_eval_step,
    make_train_step,
    value_and_grad,
)

__all__ = ["make_train_step", "make_eval_step", "loss_fn", "chunked_xent",
           "value_and_grad", "AUX_LOSS_COEF"]
