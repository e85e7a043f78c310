"""cice4_tpu — a JAX sea-ice model framework.

A from-scratch JAX/XLA implementation with the capabilities of
the CICE 4.1 (LANL) sea-ice model with COSIMA/ACCESS extensions:
EVP dynamics, incremental remapping transport, multi-category
thermodynamics with ridging, forcing/coupling, history and exact
restart — designed for SPMD execution over accelerator device meshes
(one NVIDIA GPU, or several joined by NVLink).
"""

from cice4_tpu.config import (Config, gx3_config, col_config)
from cice4_tpu.grid import Grid, make_grid, to_ugrid, to_tgrid
from cice4_tpu.state import State, ItdParams, make_itd_params, init_state

__version__ = "0.1.0"
