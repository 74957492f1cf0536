"""Configuration of the port (counterpart of config.py).

The dataclasses are the JAX package's own: that module imports no jax, so
the defaults stay defined in one place for both packages.
"""

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import (  # noqa: F401
    FeatConfig,
    FieldConfig,
    InferenceConfig,
    NerfTrainConfig,
    RegistrationConfig,
    RenderConfig,
    replace,
)
