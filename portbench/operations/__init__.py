"""What a cell's window drives, one file each, named by the mix's
`operation`. A file gives setup(config, objects, device), which does the
set-up and returns the cell's state, with its methods call(i), traced(i)
and judge(run, outputs, seed, checked_blocks)."""
