"""The plain reference the benchmark holds the program to: a dense
decoder LM (``lm``) in plain PyTorch, fp32 with TF32 off, and the lower
precision of the control (``precision``). It imports nothing of the
program: it is handed the seed's weights and inputs, as the program is,
and works out everything else itself."""
