"""The plain reference that `correct` is judged against (check.py): frozen
copies of plain code in PyTorch and numpy. Nothing here imports the program."""
