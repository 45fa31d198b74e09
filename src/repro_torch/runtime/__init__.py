"""Step builders of the port's LM paths (``steps``), the training
driver's fault tolerance (``ft``), and the spans and counters the port
records when asked (``spans``)."""
