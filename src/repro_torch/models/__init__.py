"""Model of the port: layers, attention, MoE and the decoder stack."""
