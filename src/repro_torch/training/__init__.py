from repro_torch.training.trainer import make_serve_steps, microbatch_grads
from repro_torch.training.linear_trainer import (
    fit_linear_streamed, resume_linear_streamed,
    fit_linear_streamed_resilient, streamed_accuracy,
    resume_streamed_accuracy, export_served_model, checkpoint_tree,
)

__all__ = [
    "make_serve_steps", "microbatch_grads",
    "fit_linear_streamed", "resume_linear_streamed",
    "fit_linear_streamed_resilient", "streamed_accuracy",
    "resume_streamed_accuracy", "export_served_model", "checkpoint_tree",
]
