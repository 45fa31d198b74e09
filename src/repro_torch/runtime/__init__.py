"""Step builders of the port's LM paths (``steps``) and the training
driver's fault tolerance (``ft``)."""
