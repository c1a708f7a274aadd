"""Drivers of the port: measurement into the autotune cache (``autotune``)
and the calibration fit over it (``calibrate``)."""
