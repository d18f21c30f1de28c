from .syn import apply_flow, register_syn
from .syn3d import apply_flow3d, exp_velocity3d, register_syn3d

__all__ = ["register_syn", "apply_flow", "register_syn3d", "apply_flow3d",
           "exp_velocity3d"]
