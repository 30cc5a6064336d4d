"""Matrix families, one module each, named by a configuration file's
``family``: ``shape``, ``counts`` (the frozen entries, bytes and flops of a
product), ``make`` (the matrix in the form its user holds, from the seed, on
the card), ``port_matrix`` (the port's public plan class over it) and
``Reference`` (the plain product in a stated precision, in blocks of rows)."""
