"""PSF helpers of the port (counterpart of ``biahub_tpu/psf``)."""
