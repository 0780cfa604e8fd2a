"""The benchmark of deepsphere_weather_torch on NVIDIA H100 cards (`run.py`)."""
