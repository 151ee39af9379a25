"""Experiment scripts of the port (counterparts of the reference's
``experiments/``): config-grid sweeps through the public FedDCL.fit() API
and the plan cache."""
