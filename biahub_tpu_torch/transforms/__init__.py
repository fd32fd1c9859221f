"""Point-set transforms of the port (counterpart of
``biahub_tpu/transforms``): least-squares fits and graph matching, on numpy
and scipy."""
