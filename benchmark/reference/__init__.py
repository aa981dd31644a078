"""The plain reference: plain PyTorch and NumPy in f32, importing nothing of
the program, computing again from the inputs and weights the harness hands
both sides."""
