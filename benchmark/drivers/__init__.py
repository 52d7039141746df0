"""One driver a traffic kind (a traffic file's ``kind``): it builds the
cell's inputs from the seed, warms up, runs the measured window on the
program, and holds what the window produced against the reference."""
