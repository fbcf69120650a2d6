"""Plain PyTorch reference of one training epoch of the neural canonical
transformation VMC, which the benchmark holds the program's outputs against.

It imports nothing of the program: the model (``model.py``) and the step
(``step.py``) are written out here in plain ``torch`` operations, with no
kernel and no cache.
"""
