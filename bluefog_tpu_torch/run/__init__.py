"""bfrun launcher of the port (JAX ``bluefog_tpu/run``, reference
bluefog/run/)."""
