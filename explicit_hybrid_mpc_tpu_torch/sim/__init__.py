"""Closed-loop simulation of the explicit controller against implicit
MPC (``sim/simulator.py``)."""
