"""PDE data generation on the device: the Navier-Stokes smoke, shallow-water
and Maxwell solvers and their file writers (port of
``unet_design_tpu/datagen``)."""
