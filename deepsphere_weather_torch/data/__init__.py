"""Data engine: chunked store, labeled datasets, AR indexing, scalers,
loaders and the toy generator."""

from .ar import ARIndexer, check_ar_settings, get_ar_model_tensor_info  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetView,
    SphericalDataset,
    StaticDataset,
    save_dynamic,
    save_static,
    train_val_test_split_indices,
)
from .loader import AutoregressiveDataLoader, AutoregressiveDataset  # noqa: F401
from .scalers import (  # noqa: F401
    AnomalyScaler,
    Climatology,
    GlobalMinMaxScaler,
    GlobalStandardScaler,
    SequentialScaler,
    load_scaler,
    time_group_indices,
)
from .toy import generate_toy_data  # noqa: F401
from .zarrstore import ZarrArray, ZarrGroup, create_group, open_group  # noqa: F401
