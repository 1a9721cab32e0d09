"""Parameter sweeps over the port's fleet simulator.

grid    — sweep points and the named grids (paper / quick / matrix /
          beyond)
runner  — groups points into (composition, mode) fleets, one kernel
          launch each
report  — baseline normalization and geomeans
cli     — `python -m repro_torch.sweep.cli --grid paper`
"""
