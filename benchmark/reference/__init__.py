"""The plain reference the benchmark holds the program against; it imports
torch and numpy only, and nothing of the program."""
