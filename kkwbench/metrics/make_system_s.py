"""make_system_s: host seconds of the port's program read and system build,
circuit.bincode.load_program_arrays and make_system (its compile, or its
read from the compile cache).  Moves setup_s."""


def read(window, part):
    return window.make_system_s
