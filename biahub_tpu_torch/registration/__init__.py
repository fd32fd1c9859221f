"""Transform QC of the port (counterpart of ``biahub_tpu/registration``)."""
