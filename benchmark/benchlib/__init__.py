"""The benchmark's own code. The yardstick (`traffic`, `weights`,
`arith`, `devtime`, `common`) imports nothing of the program; the cell
drivers (`train_cell`, `eval_cell`) and `probe` drive it."""
