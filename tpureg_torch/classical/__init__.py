from .syn3d import apply_flow3d, exp_velocity3d

__all__ = ["apply_flow3d", "exp_velocity3d"]
