"""The port's LM stack (dense family): layers, attention, the decoder."""
