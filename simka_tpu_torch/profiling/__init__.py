"""Capability probes of the GPU (the TPU probes' counterparts), and
the device-time trace of a ``simka`` run."""
