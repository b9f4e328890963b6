"""Model layer: pyramidal BiLSTM listener, attention speller, LAS assembly."""
