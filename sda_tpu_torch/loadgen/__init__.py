"""Load and capacity benches of the port: counterpart of
``sda_tpu/loadgen/``. Only the model-scale device-plane bench
(``devscale``) is ported; the HTTP load, pickup, connection-storm and
input benches come with ROADMAP item 14."""

from .devscale import DevScaleProfile, run_devscale

__all__ = ["DevScaleProfile", "run_devscale"]
