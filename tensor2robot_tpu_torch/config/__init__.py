"""Config system: gin-compatible dependency injection (see gin_lite.py)."""

from tensor2robot_tpu_torch.config.gin_lite import (
    ConfigError,
    bind_parameter,
    clear_config,
    config_scope,
    config_str,
    configurable,
    external_configurable,
    get_configurable,
    operative_config_str,
    parse_config,
    parse_config_files_and_bindings,
    query_parameter,
)


def register_framework_configurables() -> None:
  """Registers the port's public surface (gin's import side effects)."""
  from tensor2robot_tpu_torch.config import registrations  # pylint: disable=import-outside-toplevel

  registrations.register()
