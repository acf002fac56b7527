"""The plain reference that decides ``correct``: plain PyTorch in
float32, written from the models' published descriptions, importing
nothing of the program under test."""
