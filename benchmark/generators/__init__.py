"""The benchmark's frozen input generators, found by the name that a
configuration file gives under ``generator``: each module has
``make(rng, **args) -> (epochs [list of float32 [N, 3]], ground truth
[list of 4x4])``.  They import nothing of the program."""
