"""Step functions and the serving launcher of the port's LM path."""
