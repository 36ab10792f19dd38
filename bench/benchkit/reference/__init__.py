"""Plain references, one module a model family: the published equations in
float32 (TF32 off on the card), written with plain ``torch`` operations,
importing nothing of the program and using none of its kernels. Each reads
the benchmark's weights (the very tensors the program was given) and works
out everything else itself. ``fp8=True`` computes every product with its
operands rounded to float8 e4m3 (per-row scales for activations,
per-output-column scales for weights): the control that a lower precision
must fail."""
