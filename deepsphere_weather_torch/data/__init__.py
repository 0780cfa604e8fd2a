"""Host-side data pieces of the serving path: AR indexing and scalers."""

from .ar import ARIndexer, check_ar_settings  # noqa: F401
from .scalers import GlobalStandardScaler, load_scaler  # noqa: F401
