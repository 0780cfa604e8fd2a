"""Plotting/reporting (reference: modules/my_plotting.py, xsphere plots).

The port's copy of `deepsphere_weather_tpu/plotting/` (matplotlib with the
Agg backend; PIL for GIFs without ffmpeg), plus the training curves of
`engine.ARTrainingInfo.plots`. matplotlib and PIL are imported here and
nowhere else in the port: the card's import paths never load them, and the
CLI imports this package only in its plot step.
"""

from .skills import (  # noqa: F401
    plot_map,
    plot_skill_maps,
    plot_global_skill,
    plot_global_skills,
    plot_skills_distribution,
    benchmark_global_skill,
    benchmark_global_skills,
)
from .hovmoller import (  # noqa: F401
    HovmollerDiagram,
    create_hovmoller_plots,
    hovmoller_data,
    plot_hovmoller,
)
from .animation import (  # noqa: F401
    create_gif_forecast_anom_error,
    create_gif_forecast_error,
    create_gif_forecast_evolution,
)
from .mesh import (  # noqa: F401
    SphereField,
    plot_mesh,
    plot_polygons,
    voronoi_patches,
)
from .training import plot_training_info  # noqa: F401
