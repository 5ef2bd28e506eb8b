"""repro_torch.models: the LM stack (dense, vlm, hybrid, moe, ssm and
audio families), the port of the JAX package's ``repro.models``."""
from repro_torch.models.model import (ModelAPI, build_model,
                                      decode_state_specs, input_specs,
                                      param_specs)

__all__ = ["ModelAPI", "build_model", "decode_state_specs", "input_specs",
           "param_specs"]
