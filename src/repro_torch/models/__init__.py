"""The port's LM stack (dense and MoE families): layers, attention, the
MoE layer, the decoder."""
