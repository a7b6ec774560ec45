"""The plain reference of the benchmark's training cells: the model
stacks, the objectives and the clipped Adam step in plain PyTorch.

It imports nothing of the program under test and takes none of its
outputs: the harness hands it the same seeded weights and batches that it
hands the program. Each stack lives in a module named after the
configuration's ``arch`` (``dense``) with the functions
``param_specs(model)`` and ``forward_hidden(params, model, tokens, pr)``.
"""
