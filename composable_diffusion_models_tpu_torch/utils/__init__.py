from .config import Config, PRESETS, get_config, save_yaml
from .metrics import MetricWriter, Timer

__all__ = ["Config", "PRESETS", "get_config", "save_yaml", "MetricWriter",
           "Timer"]
