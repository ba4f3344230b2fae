"""Core of the port: quantization, IR, CA, power model, plan, Program."""
