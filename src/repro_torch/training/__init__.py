from repro_torch.training.trainer import make_serve_steps

__all__ = ["make_serve_steps"]
