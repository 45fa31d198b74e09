"""Step builders of the port's LM serving path."""
