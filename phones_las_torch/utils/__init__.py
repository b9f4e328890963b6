"""Device rule, artifact loading and metrics of the port."""
