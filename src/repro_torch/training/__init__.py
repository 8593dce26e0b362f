from repro_torch.training.trainer import (TrainHparams, TrainState,
                                          init_train_state, make_optimizer,
                                          make_serve_steps, make_train_step,
                                          microbatch_grads)
from repro_torch.training.linear_trainer import (
    fit_linear_streamed, resume_linear_streamed,
    fit_linear_streamed_resilient, streamed_accuracy,
    resume_streamed_accuracy, export_served_model, checkpoint_tree,
)

__all__ = [
    "TrainHparams", "TrainState", "init_train_state", "make_optimizer",
    "make_train_step", "make_serve_steps", "microbatch_grads",
    "fit_linear_streamed", "resume_linear_streamed",
    "fit_linear_streamed_resilient", "streamed_accuracy",
    "resume_streamed_accuracy", "export_served_model", "checkpoint_tree",
]
