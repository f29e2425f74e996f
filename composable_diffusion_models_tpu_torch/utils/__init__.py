from .config import Config, PRESETS, get_config, save_yaml

__all__ = ["Config", "PRESETS", "get_config", "save_yaml"]
