"""Config & experiment management (port of `deepsphere_weather_tpu/config`)."""

from .settings import (  # noqa: F401
    get_default_settings,
    get_default_model_settings,
    get_default_training_settings,
    get_default_ar_settings,
    get_default_dataloader_settings,
    get_default_swag_settings,
    read_config_file,
    write_config_file,
    get_model_settings,
    get_training_settings,
    get_ar_settings,
    get_dataloader_settings,
    get_swag_settings,
    check_same_dict,
    get_model_name,
    create_experiment_directories,
)
