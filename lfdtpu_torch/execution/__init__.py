from .jax_convert import jax_variables_to_state_dict

__all__ = ["jax_variables_to_state_dict"]
