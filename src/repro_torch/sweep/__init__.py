"""Parameter sweeps over the port's fleet simulator.

grid    — sweep points and the named grids (paper / quick / matrix /
          stress / mixed / beyond / endurance / sensitivity)
runner  — groups points into (composition, mode, length, wear) fleets,
          all of them in one kernel launch
report  — baseline normalization, geomeans, lifetime and sensitivity
          tables, bootstrap CIs
cli     — `python -m repro_torch.sweep.cli --grid paper`
"""
